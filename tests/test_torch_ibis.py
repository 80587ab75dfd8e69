"""The port's IBIS (SMC² with the exact Kalman inner filter) against the
JAX package: its Kalman bank step against JAX's ``kalman_step`` vmapped
over θ, one IBIS step from a JAX state carried across by ``interop``
against JAX's step, the posterior against the exact prior-IS oracle, and
IBIS against SMC² on the same series (the JAX tests' 0.3 and 0.35)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sequential_monte_carlo_tpu as jsmc
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch import interop
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
TOL = dict(rtol=1e-5, atol=1e-5)
IBIS_FIELDS = ("theta", "log_omega", "mean", "cov", "log_z", "ess", "acc_ratio")


def _jax_prior():
    f = jnp.float32
    return jsmc.product_distribution([
        jsmc.TruncatedNormal(f(0.0), f(1.0), f(-1.0), f(1.0)),
        jsmc.LogNormal(f(0.0), f(1.0)), jsmc.LogNormal(f(0.0), f(1.0))])


@pytest.fixture(scope="module")
def lg_setup():
    """The JAX tests' series: simulate(key(1998), lg_model(0.5, 0.9, 0.8), 100)."""
    _, y = jsmc.simulate(jax.random.key(1998), jsmc.lg_model(jnp.array([0.5, 0.9, 0.8])), 100)
    return prior_from_spec(LG_PRIOR, device="cpu"), torch.from_numpy(np.array(y, np.float32))


@pytest.fixture(scope="module")
def oracle_mean(lg_setup):
    """The exact posterior mean: prior importance sampling (100,000 θ)
    weighted by the port's Kalman likelihood."""
    prior, y = lg_setup
    theta = prior.sample(torch.Generator().manual_seed(77), (100_000,))
    _, lz = tsmc.kalman_log_likelihood(tsmc.lg_model(theta), y)
    return (torch.softmax(lz.double(), 0) @ theta.double()).numpy()


def test_kalman_bank_matches_jax_kalman_step():
    """The port's batched Kalman step over a θ-cloud (IBIS's bank) against
    JAX's kalman_step vmapped over θ, for three steps from (x0, Σ0): means,
    covariances and log-likelihoods to 1e-5."""
    rng = np.random.default_rng(3)
    theta = np.stack([rng.uniform(-0.9, 0.9, 32), rng.uniform(0.2, 2.0, 32),
                      rng.uniform(0.2, 2.0, 32)], 1).astype(np.float32)
    ys = rng.normal(0.0, 1.5, 3).astype(np.float32)
    models_t = tsmc.lg_model(torch.from_numpy(theta))
    models_j = jax.vmap(jsmc.lg_model)(jnp.asarray(theta))
    st_t = tsmc.kalman_init(models_t)
    st_j = jax.vmap(jsmc.kalman_init)(models_j)
    for y in ys:
        out_t = tsmc.kalman_step(models_t, st_t, torch.tensor(y))
        out_j = jax.vmap(lambda m, s: jsmc.kalman_step(m, s, y))(models_j, st_j)
        for a, b in ((out_t.state.mean, out_j.state.mean), (out_t.state.cov, out_j.state.cov),
                     (out_t.log_lik, out_j.log_lik)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        st_t, st_j = out_t.state, out_j.state


def test_ibis_step_from_a_jax_state_matches_jax(lg_setup):
    """One IBIS step without a rejuvenation from a JAX state carried across
    (``interop.from_numpy_ibis_state``) is JAX's step: Kalman means,
    covariances, log Z, log ω and the θ-ESS to 1e-5."""
    prior, y = lg_setup
    cfg = jsmc.SMCConfig(n_theta=64, chain=2, ess_threshold=0.01)
    ibis_j = jsmc.IBIS(jsmc.lg_model, _jax_prior(), cfg)
    st_j = ibis_j.init(jax.random.key(3), jnp.asarray(y.numpy()))
    st_t = interop.from_numpy_ibis_state({k: np.asarray(getattr(st_j, k))
                                          for k in IBIS_FIELDS + ("t",)}, device="cpu")
    assert st_t.t == 1 and st_t.mean.shape == (64, 1) and st_t.cov.shape == (64, 1, 1)
    ibis_t = tsmc.IBIS(tsmc.lg_model, prior, tsmc.SMCConfig(n_theta=64, chain=2,
                                                            ess_threshold=0.01))
    for _ in range(3):
        st_j, info_j = ibis_j.step(st_j, jnp.asarray(y.numpy()))
        st_t, info_t = ibis_t.step(torch.Generator().manual_seed(0), st_t, y)
        assert not bool(info_j.rejuvenated) and not bool(info_t.rejuvenated)
    assert st_t.t == int(st_j.t) == 4
    for k in ("mean", "cov", "log_z", "log_omega", "ess"):
        np.testing.assert_allclose(getattr(st_t, k).numpy(), np.asarray(getattr(st_j, k)),
                                   rtol=1e-5, atol=1e-4)


def test_ibis_posterior_matches_oracle(lg_setup, oracle_mean):
    """IBIS at the JAX test's configuration (M=256, chain=3) recovers the
    exact posterior mean within 0.3, rejuvenating along the way."""
    prior, y = lg_setup
    ibis = tsmc.IBIS(tsmc.lg_model, prior, tsmc.SMCConfig(n_theta=256, chain=3))
    state, infos = ibis.run(torch.Generator().manual_seed(6), y)
    assert infos.ess.shape == (y.shape[0] - 1,) and bool(infos.rejuvenated.any())
    assert 0.0 < infos.acc_ratio[infos.rejuvenated].mean().item() <= 1.0
    got = tsmc.expected_parameters(state).numpy()
    assert np.all(np.abs(got - oracle_mean) < 0.3), (got, oracle_mean)


def test_ibis_smc2_agree(lg_setup):
    """IBIS and SMC² (M=192, N=256, chain=3) on the same series: posterior
    means within 0.35 (JAX's test_ibis_smc2_agree)."""
    prior, y = lg_setup
    s_pf, _ = tsmc.SMC2(tsmc.lg_model, prior,
                        tsmc.SMCConfig(n_particles=256, n_theta=192, chain=3)).run(
        torch.Generator().manual_seed(8), y)
    s_kf, _ = tsmc.IBIS(tsmc.lg_model, prior, tsmc.SMCConfig(n_theta=192, chain=3)).run(
        torch.Generator().manual_seed(8), y)
    a = tsmc.expected_parameters(s_pf).numpy()
    b = tsmc.expected_parameters(s_kf).numpy()
    assert np.all(np.abs(a - b) < 0.35), (a, b)
