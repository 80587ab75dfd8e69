"""The port's auxiliary particle filter (``PFConfig(algorithm="apf")``)
through the batched filter and SMC² against the JAX package, in three tiers:
exact (one step from the same cloud, weights, offsets u0 and normals through
the JAX package's ``_batched_apf_step`` pieces, its Pallas kernels in TPU
interpret mode), distributional (APF log Z against the exact log Z of the
filter's target and against the JAX batched APF) and posterior (SMC² with
APF inner filters against the exact posterior). JAX draws with threefry and
the port with PyTorch's generators, so only the exact tier shares random
numbers, injected as numpy arrays."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import sequential_monte_carlo_tpu as jsmc
from sequential_monte_carlo_tpu.kernels.propagate_pallas import fused_elementwise_step as jax_fused_step
from sequential_monte_carlo_tpu.kernels.resample_walk import count_ancestors as jax_count_ancestors
from sequential_monte_carlo_tpu.kernels.resample_walk import resample_gather_walk
from sequential_monte_carlo_tpu.models.linear_gaussian import _lg_update as jax_lg_update
from sequential_monte_carlo_tpu.models.ucsv import _ucsv_update as jax_ucsv_update
from sequential_monte_carlo_tpu.ops.batched_filter import _row_normalize
from sequential_monte_carlo_tpu.ops.batched_filter import batched_log_likelihood as jax_loglik
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.kernels.resample_walk import count_ancestors
from sequential_monte_carlo_tpu_torch.models import ucsv as tucsv
from sequential_monte_carlo_tpu_torch.models.linear_gaussian import LinearGaussianModel
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

APF = tsmc.PFConfig("systematic", 1.0, algorithm="apf")
LG_THETA = (0.5, 0.9, 0.8)  # θ* = (A, Q, R)
LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
UCSV_PRIOR = [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0), ("uniform", 0.0, 2.0),
              ("uniform", 0.0, 2.0)]


def _jax_injected(update, n_state):
    """A JAX update reading its normals from pass-through state planes
    (interpret mode's in-kernel PRNG is a stub)."""
    def f(par, y, state, normals):
        new, logw = update(par, y, state[:n_state], state[n_state:])
        return tuple(new) + tuple(state[n_state:]), logw
    return f


def _step_inputs(model, m, n):
    """(θ, port models, JAX models, JAX update, its parameter columns,
    particles (M, N, dx), normalized log-weights, observation)."""
    rng = np.random.default_rng(12)
    if model == "ucsv":
        theta = np.stack([rng.uniform(0.05, 0.4, m), rng.normal(3.0, 0.5, m),
                          rng.uniform(0.0, 1.0, m), rng.uniform(0.0, 1.0, m)], 1)
        theta = theta.astype(np.float32)
        ours, ref = tsmc.ucsv_model(torch.from_numpy(theta)), jax.vmap(jsmc.ucsv_model)(
            jnp.asarray(theta))
        par = (ref.gamma_eps, ref.gamma_eta)
        update, dx, y = jax_ucsv_update, 3, 3.4
        particles = rng.normal(3.0, 0.5, (m, n, 3))
        particles[..., 1:] = rng.uniform(-1.0, 1.0, (m, n, 2))
    else:
        theta = np.tile(np.array(LG_THETA, np.float32), (m, 1))
        theta[:, 0] += np.linspace(-0.2, 0.2, m, dtype=np.float32)
        ours, ref = tsmc.lg_model(torch.from_numpy(theta)), jax.vmap(jsmc.lg_model)(
            jnp.asarray(theta))
        par = (ref.A[:, 0, 0], jnp.sqrt(ref.Q[:, 0, 0]), ref.B[:, 0], ref.R)
        update, dx, y = jax_lg_update(1), 1, 0.7
        particles = rng.standard_normal((m, n, 1))
    a = 2.0 * rng.standard_normal((m, n))
    lw = (a - np.log(np.exp(a).sum(-1, keepdims=True))).astype(np.float32)
    return ours, ref, update, par, dx, particles.astype(np.float32), lw, y


@pytest.mark.parametrize("model", ["ucsv", "lg"])
def test_apf_step_from_draws_matches_jax_pieces(model):
    """Exact tier: one APF step from the same cloud, log-weights, u0 and
    normals ≡ ``_batched_apf_step``'s pieces — the lookahead through the
    transition mean, ``_row_normalize``, the count-route walk on the cloud
    with the lookahead plane (interpret mode), the builder without the
    normalize, the correction. Ancestors agree on all but < 1e-3 of slots
    (f64 vs f32 cumsum); where they agree the particles, on rows where they
    all agree the log-weights and ESS match to 1e-5 and log_mean to 1e-4."""
    m, n = 8, 256
    ours, ref, update, par, dx, particles, lw, y = _step_inputs(model, m, n)
    rng = np.random.default_rng(13)
    u0 = rng.random((m, 1)).astype(np.float32)
    normals = rng.standard_normal((dx, m, n)).astype(np.float32)
    cloud = torch.from_numpy(np.ascontiguousarray(particles.transpose(0, 2, 1)))
    out = tbf._apf_step_from_draws(torch.from_numpy(u0), torch.from_numpy(normals), ours,
                                   cloud.transpose(1, 2), torch.from_numpy(lw), torch.tensor(y),
                                   APF)
    out = [t.numpy().copy() for t in out]  # before the interpret-mode kernels run

    log_n = jnp.log(jnp.float32(n))
    mu = jax.vmap(lambda md, x: md.transition_distribution(x).mean())(ref, jnp.asarray(particles))
    log_g = jax.vmap(lambda md, mm: md.observation_distribution(mm).log_prob(y))(ref, mu)
    lam_norm, lam_mean, _ = _row_normalize(jnp.asarray(lw) + log_g, log_n)
    aug = jnp.concatenate([jnp.asarray(particles), log_g[..., None]], -1).transpose(0, 2, 1)
    with pltpu.force_tpu_interpret_mode():
        gathered = resample_gather_walk(None, jnp.exp(lam_norm), aug, u0=jnp.asarray(u0))
        planes = tuple(gathered[:, i] for i in range(dx)) + tuple(map(jnp.asarray, normals))
        new_j, incr_j = jax.block_until_ready(jax_fused_step(
            _jax_injected(update, dx), 0, y, par, planes, n_normals=dx, normalize=False))
    log_norm_j, corr_mean, ess_j = _row_normalize(incr_j - gathered[:, dx], log_n)
    log_mean_j = lam_mean + log_n + corr_mean
    part_j = np.stack([np.asarray(p) for p in new_j[:dx]], -1)

    lam_t = torch.from_numpy(lw) + ours.observation_distribution(
        ours.transition_distribution(cloud.permute(2, 0, 1)).mean()).log_prob(torch.tensor(y)).T
    anc = count_ancestors(torch.from_numpy(u0), torch.softmax(lam_t, -1)).numpy()
    agree = anc == np.asarray(jax_count_ancestors(jnp.asarray(u0), jnp.exp(lam_norm)))
    assert np.mean(~agree) < 1e-3
    rows = agree.all(1)
    assert rows.sum() >= m - 2
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[0][agree], part_j[agree], **tol)
    np.testing.assert_allclose(out[1][rows], np.asarray(log_norm_j)[rows], **tol)
    np.testing.assert_allclose(out[2][rows], np.asarray(log_mean_j)[rows], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out[3][rows], np.asarray(ess_j)[rows], **tol)


def _series(t):
    return chip_smoke.lg_series(t)


def _hp_cloud(hp, m):
    return LinearGaussianModel(**{k: getattr(hp, k).expand((m,) + tuple(getattr(hp, k).shape))
                                  .contiguous() for k in ("A", "B", "Q", "R", "x0", "sigma0")})


@pytest.mark.parametrize("model,resampling", [("lg", "systematic"), ("lg", "stratified"),
                                              ("hp", "stratified"), ("sv", "systematic")])
def test_apf_log_likelihood_matches_exact(model, resampling):
    """Distributional tier: APF log Z over 64 independent rows, N=256, T=40,
    by the delta method (E[Ẑ] = Z gives mean + var/2 ≈ log Z) within 5
    standard errors of the exact log Z of the filter's own target — the
    Kalman filter from x0' = A⁻¹x0, Σ0' = A⁻¹(Σ0 − Q)A⁻ᵀ for LG and
    Hodrick–Prescott (the filter draws x₁ ~ N(x0, Σ0) where the Kalman filter
    predicts it), chip_smoke.py's point-mass grid filter for SV. Weights
    come out normalized."""
    m, n, t = 64, 256, 40
    if model == "sv":
        mu, phi, sig = -1.0, 0.95, 0.3
        ys = chip_smoke.sv_series(mu, phi, sig, t)
        cloud = tsmc.sv_model(torch.tensor([mu, phi, sig]).expand(m, 3))
        exact = chip_smoke.sv_grid_log_z(ys, mu, phi, sig)
        y = torch.from_numpy(ys)
    else:
        y = torch.from_numpy(_series(t))
        if model == "lg":
            one = tsmc.univariate_linear_gaussian(*LG_THETA[:1], 1.0, *LG_THETA[1:], device="cpu")
        else:
            one = tsmc.hodrick_prescott(1600.0, y, init_cov=1.0)
        cloud = _hp_cloud(one, m)
        a_inv = torch.linalg.inv(one.A)
        target = tsmc.multivariate_linear_gaussian(one.A, one.B, one.Q, one.R, X0=a_inv @ one.x0,
                                                   Sigma0=a_inv @ (one.sigma0 - one.Q) @ a_inv.mT)
        exact = tsmc.kalman_log_likelihood(target, y)[1].item()
    _, lw, lz_t = tbf.batched_log_likelihood(torch.Generator().manual_seed(0), cloud, n, m, y,
                                             tsmc.PFConfig(resampling, 1.0, algorithm="apf"))
    np.testing.assert_allclose(torch.logsumexp(lw, 1).numpy(), 0.0, atol=1e-5)
    lz = lz_t.double().numpy()
    assert np.all(np.isfinite(lz))
    var = lz.var(ddof=1)
    se = math.sqrt(var / m + var**2 / (2 * (m - 1)))
    assert abs(lz.mean() + var / 2 - exact) < 5 * se, (lz.mean(), var, exact)


def test_apf_log_likelihood_matches_jax_in_distribution():
    """The LG APF log Z at θ* over 64 rows, port against the JAX batched APF
    on the CPU (XLA route): means within 5 combined standard errors."""
    m, n, t = 64, 256, 40
    y = _series(t)
    theta = np.tile(np.array(LG_THETA, np.float32), (m, 1))
    _, _, lz_t = tbf.batched_log_likelihood(torch.Generator().manual_seed(1),
                                            tsmc.lg_model(torch.from_numpy(theta)), n, m,
                                            torch.from_numpy(y), APF)
    _, _, lz_j = jax_loglik(jax.random.key(1), jax.vmap(jsmc.lg_model)(jnp.asarray(theta)), n, m,
                            jnp.asarray(y), jsmc.PFConfig("systematic", 1.0, "off",
                                                          algorithm="apf"))
    lz_t, lz_j = lz_t.double().numpy(), np.asarray(lz_j, np.float64)
    se = math.sqrt(lz_j.var(ddof=1) / m + lz_t.var(ddof=1) / m)
    assert abs(lz_j.mean() - lz_t.mean()) < 5 * se, (lz_j.mean(), lz_t.mean(), se)


@pytest.mark.parametrize("algorithm", ["bootstrap", "apf"])
def test_ucsv_log_likelihood_matches_jax_in_distribution(algorithm):
    """UC-SV filters at θ = chip_smoke.JAX_MEAN over 64 rows, N=256, T=40,
    port against the JAX batched filter on the CPU (XLA route): mean log Ẑ
    within 5 combined standard errors. The UC-SV APF's log Ẑ is not held
    against the bootstrap's by the delta method: its correction weights are
    heavy-tailed, so mean + var/2 understates its log E[Ẑ]."""
    m, n, t = 64, 256, 40
    y = chip_smoke.ucsv_series(t)
    theta = np.tile(np.array(chip_smoke.JAX_MEAN, np.float32), (m, 1))
    _, _, lz_t = tbf.batched_log_likelihood(torch.Generator().manual_seed(2),
                                            tsmc.ucsv_model(torch.from_numpy(theta)), n, m,
                                            torch.from_numpy(y),
                                            tsmc.PFConfig("systematic", 1.0, algorithm=algorithm))
    _, _, lz_j = jax_loglik(jax.random.key(2), jax.vmap(jsmc.ucsv_model)(jnp.asarray(theta)), n,
                            m, jnp.asarray(y), jsmc.PFConfig("systematic", 1.0, "off",
                                                             algorithm=algorithm))
    lz_t, lz_j = lz_t.double().numpy(), np.asarray(lz_j, np.float64)
    assert np.all(np.isfinite(lz_t))
    se = math.sqrt(lz_j.var(ddof=1) / m + lz_t.var(ddof=1) / m)
    assert abs(lz_j.mean() - lz_t.mean()) < 5 * se, (lz_j.mean(), lz_t.mean(), se)


def test_smc2_apf_recovers_the_oracle_posterior():
    """Posterior tier, as the JAX package's ``test_smc2_apf_inner_filter``:
    SMC² with APF inner filters on LG (M=192, N=256, chain=3, T=100) recovers
    the exact posterior mean (prior importance sampling weighted by the
    Kalman likelihood) within 0.3, and the median of log Z − Kalman log Z over
    the final θ-cloud is below 2."""
    y = torch.from_numpy(_series(100))
    prior = prior_from_spec(LG_PRIOR, device="cpu")
    theta = prior.sample(torch.Generator().manual_seed(77), (100_000,))
    _, kz = tsmc.kalman_log_likelihood(tsmc.lg_model(theta), y)
    oracle = (torch.softmax(kz.double(), 0) @ theta.double()).numpy()
    sampler = tsmc.SMC2(tsmc.lg_model, prior,
                        tsmc.SMCConfig(n_particles=256, n_theta=192, chain=3, ess_threshold=0.5,
                                       inner=APF))
    state, infos = sampler.run(torch.Generator().manual_seed(23), y)
    got = tsmc.expected_parameters(state).numpy()
    assert np.all(np.abs(got - oracle) < 0.3), (got, oracle)
    assert bool(infos.rejuvenated.any())
    dz = (state.log_z - tsmc.kalman_log_likelihood(tsmc.lg_model(state.theta), y)[1]).numpy()
    assert np.all(np.isfinite(dz))
    assert abs(np.median(dz)) < 2.0


def test_ucsv_apf_runs_on_the_ucsv_kernel(monkeypatch):
    """The count chip_smoke.py checks on the GPU: SMC² on UC-SV with APF
    inner filters makes T − 1 online steps plus chain·(t_r − 1) per
    rejuvenation at t_r, each one APF step whose second stage is one call of
    the UC-SV kernel's wrapper and none of kernel 2's."""
    steps, k6, k2 = [], [], []
    apf_step, k6_fn = tbf._apf_step_from_draws, tucsv.ucsv_propagate_reweight
    monkeypatch.setattr(tbf, "_apf_step_from_draws", lambda *a: steps.append(1) or apf_step(*a))
    monkeypatch.setattr(tucsv, "ucsv_propagate_reweight",
                        lambda *a, **k: k6.append(1) or k6_fn(*a, **k))
    monkeypatch.setattr(tucsv, "fused_elementwise_step", lambda *a, **k: k2.append(1))
    t, chain = 30, 2
    sampler = tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(UCSV_PRIOR, device="cpu"),
                        tsmc.SMCConfig(n_particles=64, n_theta=16, chain=chain, inner=APF))
    state, infos = sampler.run(torch.Generator().manual_seed(1),
                               torch.from_numpy(chip_smoke.ucsv_series(t)))
    rejuv_t = (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist()
    assert rejuv_t, "the series should degenerate the θ-cloud at least once"
    expected = (t - 1) + sum(chain * (r - 1) for r in rejuv_t)
    assert len(steps) == len(k6) == expected and not k2
    assert math.isfinite(state.ess.item())


@pytest.mark.parametrize("config,match", [
    (tsmc.PFConfig("systematic", 0.5, algorithm="apf"), "ess_threshold"),
    (tsmc.PFConfig("systematic", 1.0, proposal=object(), algorithm="apf"), "proposal"),
    (tsmc.PFConfig("systematic", 1.0, algorithm="guided"), "unknown algorithm"),
])
def test_apf_config_errors(config, match):
    """The JAX package's ValueErrors for what the APF does not compose with,
    and for an unknown algorithm."""
    models = tsmc.lg_model(torch.tensor(LG_THETA).expand(4, 3))
    y = torch.from_numpy(_series(3))
    with pytest.raises(ValueError, match=match):
        tbf.batched_log_likelihood(torch.Generator().manual_seed(0), models, 64, 4, y, config)


def test_apf_refuses_elastic_active_n():
    models = tsmc.lg_model(torch.tensor(LG_THETA).expand(4, 3))
    init = tbf.batched_pf_init(torch.Generator().manual_seed(0), models, 64, 4, torch.tensor(0.1))
    with pytest.raises(ValueError, match="apf"):
        tbf.batched_pf_step(torch.Generator().manual_seed(1), models, init.particles,
                            init.log_weights, torch.tensor(0.2), APF, active_n=torch.tensor(32))
