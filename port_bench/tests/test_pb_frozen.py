"""The cells' inputs and counts, found by name (series kinds, prior kinds,
the models' step counts), are bitwise those recorded before they moved
into files of their own: the series' bytes, the prior's draws, log
densities and supports for a seed (the θ banks' stream), and the counts
at the cells' shapes."""
import hashlib
import json

import pytest
import torch

from port_bench.counts import inner_step, propagate, resample
from port_bench.harness import catalog, seeds, series
from port_bench.reference.priors import Prior

torch.set_num_threads(1)

SERIES = {"ucsv_bench": "506f50f509f47e27e7f78d230c582416838b28fb86c0e05ab5cb379ed4da1ce7",
          "lg_ar1_large_n": "93f13d06de40704fa2d8ccdb56e8105d5be0cebe609f3e4d277ba3b2db7b3618"}
# sha256 of (draws of 256 x 64 rows from the stream "inputs", log_prob of
# 512 float64 draws from the seed, in_support of those draws x 1.7 - 0.3)
PRIOR = {
    ("ucsv_bench", 5): ("25be118e250ca9e96718a517090e46a57a5a36d4785a674b4b9d9040e14bdbb8",
                        "a886836383337247730883c95249a2dc5527d122789eb60841c4bbe3599b6cbc",
                        "57ef7f52e6f14d6082844953c24a495aaea8d17c578c70dd1168b17665dfec25"),
    ("ucsv_bench", 2**31 + 11): (
        "174ee5c786f6d30de3af6e9178e543567352272210bdecd2c388d79cf6aa7683",
        "570a0207205b65ed4906b70f1d5b86dcaf893a4ae873dc9dfbf693eff8953835",
        "ec7e8ce22a8a3e93487ac34d4bf77642022b133a3471a5f6f722c883ea345891"),
    ("ucsv_bench", 3000000123): (
        "fb13ca73fe4fa4e997c088ae348148c528dd92267ff0af30ff3ec97f73bfeda5",
        "b29caa58330784dbe0e0feaa5b4e632cc7158101e7b481c65299c44011ec2ff7",
        "86e98fd77ac4ba775beaf74ebdbc78d5e797c5da0fe8d34f4e24ab6387325f84"),
    ("lg_ar1_large_n", 5): ("575f7994ef6f66ddb4baf7293778c8e0c5bae50a23afdfd4cd5932fd6b1e7427",
                            "85f571f214872b799a5c3570831ff10d85cd9e798979c85f804f50851670d0c2",
                            "24a66911155547d352ba0fc99509742e11e96447f27f19a54e92493bd9a715ee"),
    ("lg_ar1_large_n", 2**31 + 11): (
        "999a3e4c41d43e06220bae0837eb4be1ac91998f23a2232e0e9b40fc74570581",
        "5c4ca702c41a0053e3fee99dc5e61da91defba04a96555d572388f38cdfa1084",
        "286d851fedbacbeeef1274ba99a4f4da02c6e3eb768737b9d7f628d69a40a7cc"),
    ("lg_ar1_large_n", 3000000123): (
        "1efe46bdfb52b14b4685d8d8d338853d6b1c0bb5aa8a55ebd6d17d1a961cf1f9",
        "583233a291d75934812d7093023f1d97c3e052926aa117c39918907758f73639",
        "666a87b6a846872645e7a7fc1b6b28fb63d6cdda2c9cf4bcefeecbd820baf7a3"),
}
# (m, n, planes, parameters, model): propagate bytes (carry, normalize) for
# (F, F), (F, T), (T, F), (T, T), its flops normalized and raw, the inner
# step's bytes and flops, resample bytes without and with the grid, flops
COUNTS = {
    (512, 8192, 3, 2, "ucsv"): ((117444608, 117448704, 134221824, 134225920),
                                (163577856, 134217728), (134217728, 230686720.0),
                                (117442560, 134217728, 67108864.0)),
    (64, 65536, 1, 3, "lg"): ((50332416, 50332928, 67109632, 67110144), (79691776, 50331648),
                              (67108864, 159383552.0), (50331904, 67108864, 79691776.0)),
    (512, 1024, 3, 2, "ucsv"): ((14684160, 14688256, 16781312, 16785408), (20447232, 16777216),
                                (16777216, 27262976.0), (14682112, 16777216, 6815744.0)),
}


def _sha(array) -> str:
    return hashlib.sha256(array.tobytes()).hexdigest()


def _config(name: str) -> dict:
    (entry,) = [c for c in catalog.benchmark()["configs"] if c["name"] == name]
    with open(catalog.ROOT / entry["file"]) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(SERIES))
def test_series_bytes(name):
    y = series.make(_config(name)["series"])
    assert y.dtype.str == "<f4" and _sha(y) == SERIES[name]


@pytest.mark.parametrize("name,seed", sorted(PRIOR))
def test_prior_draws_densities_supports(name, seed):
    prior = Prior(_config(name)["prior"])
    gen = torch.Generator().manual_seed(seeds.stream_seed(seed, "inputs"))
    draws = prior.sample(gen, 256 * 64, "cpu")
    theta = prior.sample(torch.Generator().manual_seed(seed), 512, "cpu", torch.float64)
    got = (_sha(draws.numpy()), _sha(prior.log_prob(theta).numpy()),
           _sha(prior.in_support(theta * 1.7 - 0.3).numpy()))
    assert got == PRIOR[(name, seed)]


@pytest.mark.parametrize("shape", sorted(COUNTS))
def test_counts(shape):
    m, n, s, p, model = shape
    got = (tuple(propagate.nbytes(m, n, s, p, carry, norm)
                 for carry in (False, True) for norm in (False, True)),
           (propagate.flops(m, n, model), propagate.flops(m, n, model, False)),
           (inner_step.nbytes(m, n, s), inner_step.flops(m, n, model)),
           (resample.nbytes(m, n, s), resample.nbytes(m, n, s, True), resample.flops(m, n)))
    assert got == COUNTS[shape]
