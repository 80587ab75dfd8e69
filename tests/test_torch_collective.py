"""The port's particle-axis building blocks (parallel/collective.py,
ops.weights.normalize_sharded) on 4 gloo ranks of the CPU against the JAX
package's under shard_map on 4 virtual devices — the twin of
tests/test_collective.py. The JAX numbers are made here and cross to the
ranks (tests/torch_dist_worker.py, suite "collective") as an .npz."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import sequential_monte_carlo_tpu as smc
from sequential_monte_carlo_tpu.ops.weights import normalize_sharded
from sequential_monte_carlo_tpu.parallel.collective import distributed_systematic_resample
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
