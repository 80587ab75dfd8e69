"""The PyTorch port's inner filter step and SMC² against the JAX package, in
three tiers: exact (same state and same draws through both packages'
kernels), distributional (PF log Z at a fixed θ) and posterior (small SMC²
runs). JAX draws with threefry and the port with PyTorch's generators, so
only the exact tier shares random numbers, injected as numpy arrays."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import sequential_monte_carlo_tpu as jsmc
from sequential_monte_carlo_tpu.kernels.propagate_pallas import fused_elementwise_step as jax_fused_step
from sequential_monte_carlo_tpu.kernels.resample_walk import count_ancestors as jax_count_ancestors
from sequential_monte_carlo_tpu.kernels.resample_walk import resample_gather_walk
from sequential_monte_carlo_tpu.models.ucsv import _ucsv_update
from sequential_monte_carlo_tpu.ops.batched_filter import (
    batched_log_likelihood_masked as jax_loglik_masked,
)
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.interop import from_numpy_state, prior_from_spec
from sequential_monte_carlo_tpu_torch.kernels.resample_walk import count_ancestors
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf

# One intra-op thread: with torch's OpenMP workers in a process that also runs
# the JAX package, plain-path results came out of some runs with ~1e-4
# relative error on the rows of one worker's chunk (root cause not found;
# ROADMAP Queue 3). The tests are small, so nothing is lost.
torch.set_num_threads(1)

BENCH_PRIOR = [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
               ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)]


def _series(t):
    """bench.py's synthetic inflation-like series, first t points."""
    rng = np.random.default_rng(1998)
    y = 3.0 + np.cumsum(rng.normal(0, 0.3, 241)) + rng.normal(0, 0.5, 241)
    return y.astype(np.float32)[:t]


def _jax_prior():
    kinds = {"uniform": jsmc.Uniform, "normal": jsmc.Normal}
    return jsmc.product_distribution(
        [kinds[k](jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
         for k, a, b in BENCH_PRIOR])


def _jax_update_injected(par, y, state, normals):
    """JAX UC-SV update reading its normals from three pass-through state
    planes (interpret mode's in-kernel PRNG is a stub)."""
    new, logw = _ucsv_update(par, y, state[:3], state[3:])
    return tuple(new) + tuple(state[3:]), logw


def test_pf_step_from_draws_matches_jax_kernels():
    """Exact tier: from the same JAX SMC² state (converted by interop) and
    the same u0 and normals, one port step ≡ the JAX composition of its two
    Pallas kernels (interpret mode). Ancestors agree on all but < 1e-3 of
    slots (f32 ties); where a row's ancestors all agree, particles,
    log-weights, evidence and ESS match to rtol 1e-5 (exp/log in another
    library)."""
    m, n = 16, 1024
    y = _series(5)
    sampler = jsmc.SMC2(jsmc.ucsv_model, _jax_prior(),
                        jsmc.SMCConfig(n_particles=n, n_theta=m, chain=2))
    st_j = sampler.init(jax.random.key(3), jnp.asarray(y))
    fields = {k: np.asarray(getattr(st_j, k)) for k in (
        "theta", "log_omega", "particles", "log_w", "log_z", "ess", "acc_ratio", "t")}
    st = from_numpy_state(fields, device="cpu")
    assert st.particles.transpose(1, 2).is_contiguous()  # planar storage
    np.testing.assert_array_equal(st.particles.numpy(), fields["particles"])

    rng = np.random.default_rng(7)
    u0 = rng.random((m, 1)).astype(np.float32)
    normals = rng.standard_normal((3, m, n)).astype(np.float32)
    w_j = jnp.exp(st_j.log_w)
    gamma = st_j.theta[:, 0]
    with pltpu.force_tpu_interpret_mode():
        xp = resample_gather_walk(None, w_j, st_j.particles.transpose(0, 2, 1),
                                  u0=jnp.asarray(u0))
        planes = (xp[:, 0], xp[:, 1], xp[:, 2]) + tuple(jnp.asarray(z) for z in normals)
        new_j, log_norm_j, lse_j, ess_j = jax_fused_step(
            _jax_update_injected, 0, y[1], (gamma, gamma), planes, n_normals=3,
            normalize=True)
    part_j = np.stack([np.asarray(p) for p in new_j[:3]], -1)
    log_mean_j = np.asarray(lse_j[:, 0] - jnp.log(jnp.float32(n)))

    out = tbf._pf_step_from_draws(torch.from_numpy(u0), torch.from_numpy(normals),
                                  tsmc.ucsv_model(st.theta), st.particles, st.log_w,
                                  torch.tensor(y[1]))
    anc = count_ancestors(torch.from_numpy(u0), torch.exp(st.log_w)).numpy()
    agree = anc == np.asarray(jax_count_ancestors(jnp.asarray(u0), w_j))
    assert np.mean(~agree) < 1e-3
    rows = agree.all(1)
    assert rows.sum() >= m - 2
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.particles.numpy()[agree], part_j[agree], **tol)
    np.testing.assert_allclose(out.log_weights.numpy()[rows], np.asarray(log_norm_j)[rows], **tol)
    np.testing.assert_allclose(out.log_mean.numpy()[rows], log_mean_j[rows], **tol)
    np.testing.assert_allclose(out.ess.numpy()[rows], np.asarray(ess_j)[rows, 0], **tol)


def test_pf_log_likelihood_matches_jax_in_distribution():
    """Distributional tier: the UC-SV PF log Z at one θ, repeated over 64
    rows (independent filters), port vs the JAX batched filter on the CPU
    (XLA route): means within 5 combined standard errors."""
    m, n, t = 64, 512, 40
    y = _series(t)
    theta = np.tile(np.array([0.2, 3.0, 0.2, 0.3], np.float32), (m, 1))
    models_j = jax.vmap(jsmc.ucsv_model)(jnp.asarray(theta))
    _, _, lz_j = jax_loglik_masked(jax.random.key(0), models_j, n, m, jnp.asarray(y),
                                   jnp.ones(t), jsmc.PFConfig("systematic", 1.0))
    _, lw, lz_t = tbf.batched_log_likelihood_masked(
        torch.Generator().manual_seed(0), tsmc.ucsv_model(torch.from_numpy(theta)), n, m,
        torch.from_numpy(y), torch.ones(t), tsmc.PFConfig())
    lz_j, lz_t = np.asarray(lz_j, np.float64), lz_t.double().numpy()
    assert np.all(np.isfinite(lz_t))
    np.testing.assert_allclose(torch.logsumexp(lw, 1).numpy(), 0.0, atol=1e-5)
    se = math.sqrt(lz_j.var(ddof=1) / m + lz_t.var(ddof=1) / m)
    assert abs(lz_j.mean() - lz_t.mean()) < 5 * se, (lz_j.mean(), lz_t.mean(), se)


# seed spread (sd over 16 seeds) of the posterior mean at M=64, N=256, T=40,
# chain=2 on the CPU, per component of θ = (γ, x0, log σε0, log ση0): the
# larger of the JAX package's and the port's
SMALL_SD = np.array([0.05668, 0.486902, 0.141507, 0.137714])


def test_smc2_posterior_matches_jax():
    """Posterior tier: the mean over 8 seeds of the port's posterior mean
    against the same for the JAX package, at M=64, N=256, T=40, chain=2.
    Tolerance: 5 standard errors of the difference of two 8-seed means,
    5·sd·√(2/8), with sd the measured seed spread above."""
    m, n, t, chain, seeds = 64, 256, 40, 2, 8
    y = _series(t)
    cfg = dict(n_particles=n, n_theta=m, chain=chain, ess_threshold=0.5)
    jax_sampler = jsmc.SMC2(jsmc.ucsv_model, _jax_prior(), jsmc.SMCConfig(**cfg))
    port = tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cpu"), tsmc.SMCConfig(**cfg))
    jax_means, port_means = [], []
    for s in range(seeds):
        st_j, _ = jax_sampler.run(jax.random.key(s), jnp.asarray(y))
        jax_means.append(np.asarray(jsmc.expected_parameters(st_j)))
        st, infos = port.run(torch.Generator().manual_seed(s), torch.from_numpy(y))
        assert math.isfinite(st.ess.item()) and infos.ess.shape == (t - 1,)
        port_means.append(tsmc.expected_parameters(st).numpy())
    diff = np.mean(port_means, 0) - np.mean(jax_means, 0)
    tol = 5 * SMALL_SD * math.sqrt(2 / seeds)
    assert np.all(np.abs(diff) <= tol), (diff, tol)


def test_every_inner_step_is_one_kernel_pair(monkeypatch):
    """The count chip_smoke.py checks on the GPU: T − 1 online steps plus
    chain·(t_r − 1) per rejuvenation at t_r, each one pass of the kernel
    pair (``_pf_step_from_draws``)."""
    calls = []
    inner = tbf._pf_step_from_draws
    monkeypatch.setattr(tbf, "_pf_step_from_draws",
                        lambda *a: calls.append(1) or inner(*a))
    t, chain = 30, 2
    sampler = tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cpu"),
                        tsmc.SMCConfig(n_particles=64, n_theta=16, chain=chain))
    _, infos = sampler.run(torch.Generator().manual_seed(1), torch.from_numpy(_series(t)))
    rejuv_t = (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist()
    assert rejuv_t, "the series should degenerate the θ-cloud at least once"
    assert len(calls) == (t - 1) + sum(chain * (r - 1) for r in rejuv_t)


def test_run_is_init_then_steps():
    """``run`` is ``init`` plus one ``step`` per observation: the same
    generator seed gives the same posterior."""
    y = torch.from_numpy(_series(12))
    sampler = tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cpu"),
                        tsmc.SMCConfig(n_particles=64, n_theta=16, chain=2))
    st_run, _ = sampler.run(torch.Generator().manual_seed(4), y)
    gen = torch.Generator().manual_seed(4)
    st = sampler.init(gen, y)
    for _ in range(len(y) - 1):
        st, info = sampler.step(gen, st, y)
    assert st.t == len(y)
    assert torch.equal(tsmc.expected_parameters(st), tsmc.expected_parameters(st_run))


@pytest.mark.parametrize("inner", [
    tsmc.PFConfig("multinomial_typo", 1.0),
    tsmc.PFConfig("residual", 1.0, algorithm="guided"),
    tsmc.PFConfig("systematic", 1.0, proposal=object()),
])
def test_unported_filter_configs_raise(inner):
    """Every scheme, the guided proposal and the auxiliary filter are
    ported; what is no filter configuration still raises before a draw: an
    unknown scheme or algorithm (ValueError) or a proposal that is not a
    ``Proposal(initial, step)`` (TypeError)."""
    error, match = {"multinomial_typo": (ValueError, "unknown resampling scheme"),
                    "residual": (ValueError, "unknown algorithm"),
                    "systematic": (TypeError, "Proposal")}[inner.resampling]
    sampler = tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cpu"),
                        tsmc.SMCConfig(n_particles=16, n_theta=4, inner=inner))
    with pytest.raises(error, match=match):
        sampler.init(torch.Generator().manual_seed(0), torch.from_numpy(_series(3)))


def test_exchange_step_raises():
    """The exchange step is ported; an unknown padding policy raises, and the
    auxiliary filter refuses the padded mode's live count (JAX's error)."""
    with pytest.raises(ValueError, match="elastic_pad"):
        tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cpu"),
                  tsmc.SMCConfig(acc_threshold=0.3, elastic_pad="half"))
    sampler = tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cpu"),
                        tsmc.SMCConfig(n_particles=16, n_theta=4, acc_threshold=0.3,
                                       elastic_pad="full",
                                       inner=tsmc.PFConfig(algorithm="apf")))
    with pytest.raises(ValueError, match="apf"):
        sampler.init(torch.Generator().manual_seed(0), torch.from_numpy(_series(3)))
