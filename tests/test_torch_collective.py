"""The port's particle-axis building blocks (parallel/collective.py,
ops.weights.normalize_sharded) on 4 gloo ranks of the CPU against the JAX
package's under shard_map on 4 virtual devices — the twin of
tests/test_collective.py. The JAX numbers are made here and cross to the
ranks (tests/torch_dist_worker.py, suite "collective") as an .npz.

Also the pieces of the batched filter's particle-axis sharding that need no
process group: the plain K1 and K3 windows against the whole output's
slots, every resampling scheme's window of a row, and the CPU's normals and
the resample's draws kept at a rank's particles."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import sequential_monte_carlo_tpu as smc
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu.ops.weights import normalize_sharded
from sequential_monte_carlo_tpu.parallel.collective import distributed_systematic_resample
from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
    resample_gather_sorted,
    stratified_uniforms,
)
from sequential_monte_carlo_tpu_torch.kernels.resample_walk import resample_gather
from sequential_monte_carlo_tpu_torch.ops.batched_filter import (
    _draws,
    _resample_gather,
)
from sequential_monte_carlo_tpu_torch.ops.sharding import ParticleCols, ThetaRows
from torch_dist_worker import run_world

RANKS = 4


@pytest.fixture(scope="module")
def jax_side():
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("p",))
    key = jax.random.key(3)
    w = jax.nn.softmax(jax.random.normal(jax.random.key(1), (512,)) * 2)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P("p"), out_specs=P("p"))
    def resample(w_local):
        return distributed_systematic_resample(key, w_local, "p")

    log_w = 3.0 * jax.random.normal(jax.random.key(5), (8, 512))

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P(None, "p"),
                       out_specs=(P(), P(None, "p"), P()))
    def norm(lw):
        return tuple(normalize_sharded(lw, "p"))

    model = smc.lg_model(jnp.array([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(7), model, 60)
    (_, _), kz = smc.kalman_log_likelihood(model, y)
    return {"w": np.asarray(w), "u0": np.asarray(jax.random.uniform(key, (), dtype=w.dtype)),
            "ancestors": np.asarray(resample(w)), "log_w": np.asarray(log_w),
            "norm": [np.asarray(v) for v in norm(log_w)], "y": np.asarray(y),
            "kalman_log_z": float(kz)}


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    out = tmp_path_factory.mktemp("collective")
    np.savez(out / "inputs.npz", **{k: jax_side[k] for k in ("w", "u0", "log_w", "y")})
    return run_world("collective", RANKS, out)[0]


def test_distributed_resample_matches_jax(jax_side, ranks):
    """At JAX's u0 and weights, the ranks' ancestor slices are JAX's under
    shard_map, index for index."""
    got = np.concatenate([r["ancestors"] for r in ranks])
    np.testing.assert_array_equal(got, jax_side["ancestors"])


def test_gather_global_roundtrip(ranks):
    got = np.concatenate([r["gathered"][:, 0] for r in ranks])
    np.testing.assert_array_equal(got, np.flip(np.arange(256)))


def test_normalize_sharded_matches_jax(jax_side, ranks):
    log_mean, w, ess = jax_side["norm"]
    for r in ranks:
        np.testing.assert_allclose(r["log_mean"], log_mean, rtol=1e-6)
        np.testing.assert_allclose(r["ess"], ess, rtol=1e-6)
    got = np.concatenate([r["weights"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-12)


def test_distributed_pf_step_statistics(jax_side, ranks):
    """The sharded bootstrap filter at N=1024 over JAX's T=60 LG series
    tracks the Kalman log Z (within 2.0, as test_collective.py:59-94), the
    same log Z and ESS on every rank."""
    for r in ranks:
        assert r["pf_log_z"] == ranks[0]["pf_log_z"]
        np.testing.assert_array_equal(r["pf_ess"], ranks[0]["pf_ess"])
    assert abs(float(ranks[0]["pf_log_z"]) - jax_side["kalman_log_z"]) < 2.0
    assert np.isfinite(ranks[0]["pf_ess"]).all()


def _bank(m=16, n=96, c=3, seed=0):
    rng = np.random.default_rng(seed)
    a = 2.5 * rng.standard_normal((m, n))
    w = np.exp(a - a.max(-1, keepdims=True))
    return (torch.tensor(w / w.sum(-1, keepdims=True), dtype=torch.float32),
            torch.tensor(rng.standard_normal((m, c, n)), dtype=torch.float32),
            torch.tensor(rng.random((m, 1)), dtype=torch.float32))


def _windows(n, shards):
    k = n // shards
    return [ParticleCols(b * k, (b + 1) * k, n, shards, None) for b in range(shards)]


@pytest.mark.parametrize("n, shards", [(96, 2), (96, 4), (1000, 4), (1002, 2)])
def test_plain_resample_windows_equal_the_whole_outputs_slots(n, shards):
    """K1's plain version with a slot window and K3's on a window of the
    grid give the whole output's slots and ancestors of the window bit for
    bit (the cdf is the whole row's); windows off a multiple of 4 too."""
    w, xs, u0 = _bank(n=n)
    u = stratified_uniforms(torch.Generator().manual_seed(1), w.shape[0], n)
    whole1, anc1 = resample_gather(u0, w, xs, return_ancestors=True)
    whole3, anc3 = resample_gather_sorted(u, w, xs, return_ancestors=True)
    for cols in _windows(n, shards) + [ParticleCols(3, 8, n, 0, None)]:
        k = cols.hi - cols.lo
        out, anc = resample_gather(u0, w, xs, return_ancestors=True, slot_lo=cols.lo, n_out=k)
        assert out.shape == (w.shape[0], 3, k)
        assert torch.equal(out, whole1[:, :, cols.lo:cols.hi])
        assert torch.equal(anc, anc1[:, cols.lo:cols.hi])
        out, anc = resample_gather_sorted(u[:, cols.lo:cols.hi].contiguous(), w, xs,
                                          return_ancestors=True)
        assert torch.equal(out, whole3[:, :, cols.lo:cols.hi])
        assert torch.equal(anc, anc3[:, cols.lo:cols.hi])


@pytest.mark.parametrize("slot_lo, n_out", [(-1, 4), (0, 0), (90, 7)])
def test_resample_window_outside_the_row_raises(slot_lo, n_out):
    w, xs, u0 = _bank()
    with pytest.raises(ValueError, match="window"):
        resample_gather(u0, w, xs, slot_lo=slot_lo, n_out=n_out)


SCHEMES = [("systematic", None), ("residual_systematic", None), ("stratified", None),
           ("multinomial", None), ("residual", None), ("metropolis", None),
           ("systematic", 40), ("stratified", 40), ("multinomial", 40)]


@pytest.mark.parametrize("scheme, active_n", SCHEMES)
@pytest.mark.parametrize("shards", [2, 4])
def test_every_scheme_resamples_a_rows_window(scheme, active_n, shards):
    """The batched filter's resample under particle sharding: from the
    row's whole cloud and weights, each rank's window of slots is the whole
    resample's, for every scheme and the elastic live-prefix grids, from
    the same draws (the metropolis resampler's from the same generator)."""
    w, xs, _ = _bank()
    m, n = w.shape
    cfg = tsmc.PFConfig(scheme)

    def draws():
        gen = torch.Generator().manual_seed(5)
        u, _ = _draws(gen, tsmc.lg_model(torch.tensor([[0.5, 0.9, 0.8]]).repeat(m, 1)), m, n,
                      torch.device("cpu"), cfg, active_n)
        return u

    whole = _resample_gather(draws(), cfg, xs, w, active_n)
    for cols in _windows(n, shards):
        got = _resample_gather(draws(), cfg, xs, w, active_n, cols=cols)
        assert torch.equal(got, whole[:, :, cols.lo:cols.hi])


@pytest.mark.parametrize("rows", [None, 1])
@pytest.mark.parametrize("scheme", ["systematic", "stratified"])
def test_cpu_normals_and_grids_kept_at_the_ranks_particles(rows, scheme):
    """The step's draws at the whole bank's shape: a rank keeps its rows
    and particles of the CPU's (n_normals, M, N) normals — the whole draw's
    columns — and the resample's u whole along N (its window is taken in
    the resample)."""
    m, n = 8, 64
    models = tsmc.ucsv_model(torch.tensor([[0.2, 3.0, 0.5, 0.5]]).repeat(m, 1))
    cfg = tsmc.PFConfig(scheme)
    u_all, z_all = _draws(torch.Generator().manual_seed(9), models, m, n,
                          torch.device("cpu"), cfg)
    row = None if rows is None else ThetaRows(4, 8, m, 2, None)
    sl = slice(None) if row is None else slice(row.lo, row.hi)
    for cols in _windows(n, 4):
        u, z = _draws(torch.Generator().manual_seed(9), models, m, n, torch.device("cpu"), cfg,
                      rows=row, cols=cols)
        assert z.shape == (3, m if row is None else 4, 16) and z.is_contiguous()
        assert torch.equal(z, z_all[:, sl, cols.lo:cols.hi])
        assert torch.equal(u, u_all[sl])
