"""The port's widened inner filter (stratified and ESS-triggered resampling)
and density-tempered SMC on the linear-Gaussian model against the JAX
package, in three tiers: exact (one step from the same cloud, weights, grid
and normals through both packages' kernels), distributional (PF log Z at θ*
against the exact Kalman oracle and the JAX batched filter) and posterior
(small density-tempered runs over 8 seeds). JAX draws with threefry and the
port with PyTorch's generators, so only the exact tier shares random
numbers, injected as numpy arrays."""
import inspect
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import sequential_monte_carlo_tpu as jsmc
from sequential_monte_carlo_tpu.kernels.propagate_pallas import fused_elementwise_step as jax_fused_step
from sequential_monte_carlo_tpu.kernels.resample_walk import resample_gather_walk
from sequential_monte_carlo_tpu.models.linear_gaussian import _lg_update as jax_lg_update
from sequential_monte_carlo_tpu.ops.batched_filter import batched_log_likelihood as jax_loglik
from sequential_monte_carlo_tpu.ops.resampling import _inverse_cdf as jax_inverse_cdf
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch import interop
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import sorted_ancestors
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

THETA = (0.5, 0.9, 0.8)  # θ* = (A, Q, R)
LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
INNER = [("systematic", 1.0), ("stratified", 0.5), ("stratified", 1.0), ("systematic", 0.5)]


def _series(t):
    """The LG series at θ* (chip_smoke.py's): x₁ ~ N(0, 1), default_rng(1998)."""
    a, q, r = THETA
    rng = np.random.default_rng(1998)
    x, y = rng.normal(0.0, 1.0), np.empty(t)
    for i in range(t):
        if i:
            x = a * x + rng.normal(0.0, math.sqrt(q))
        y[i] = x + rng.normal(0.0, math.sqrt(r))
    return y.astype(np.float32)


def _jax_prior():
    f = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    return jsmc.product_distribution([
        jsmc.TruncatedNormal(f(0.0), f(1.0), f(-1.0), f(1.0)),
        jsmc.LogNormal(f(0.0), f(1.0)), jsmc.LogNormal(f(0.0), f(1.0))])


def _jax_lg_injected(par, y, state, normals):
    """JAX LG update reading its normal from a pass-through state plane
    (interpret mode's in-kernel PRNG is a stub)."""
    new, logw = jax_lg_update(1)(par, y, state[:1], state[1:])
    return tuple(new) + tuple(state[1:]), logw


@pytest.mark.parametrize("fire", ["half", "none", "all"])
def test_stratified_adaptive_step_matches_jax_kernels(fire):
    """Exact tier: one stratified, ESS-triggered step (threshold 0.5) on LG
    from the same cloud, weights, grid u and normals ≡ the JAX pieces — ESS
    trigger, band-route walk (interpret mode), per-row selects, the fused
    step with ``carry_logw``. Ancestors agree on all but < 1e-3 of slots
    (f64 vs f32 cumsum); on rows where they all agree, particles,
    log-weights, evidence and ESS match to rtol 1e-5."""
    m, n, y = 16, 1024, 0.7
    rng = np.random.default_rng(11)
    conc = {"half": np.where(np.arange(m) < m // 2, 3.0, 0.1), "none": np.full(m, 0.1),
            "all": np.full(m, 3.0)}[fire]
    a = conc[:, None] * rng.standard_normal((m, n))
    lw = (a - np.log(np.exp(a).sum(-1, keepdims=True))).astype(np.float32)
    particles = rng.standard_normal((m, n, 1)).astype(np.float32)
    v = rng.random((m, n)).astype(np.float32)
    u = ((np.arange(n, dtype=np.float32)[None, :] + v) / np.float32(n)).astype(np.float32)
    normals = rng.standard_normal((1, m, n)).astype(np.float32)
    theta = np.tile(np.array(THETA, np.float32), (m, 1))
    theta[:, 0] += np.linspace(-0.2, 0.2, m, dtype=np.float32)

    out = tbf._pf_step_from_draws(
        torch.from_numpy(u), torch.from_numpy(normals), tsmc.lg_model(torch.from_numpy(theta)),
        torch.from_numpy(np.ascontiguousarray(particles.transpose(0, 2, 1))).transpose(1, 2),
        torch.from_numpy(lw), torch.tensor(y), tsmc.PFConfig("stratified", 0.5))

    models_j = jax.vmap(jsmc.lg_model)(jnp.asarray(theta))
    w_j = jnp.exp(jnp.asarray(lw))
    do = (1.0 / jnp.sum(w_j * w_j, axis=-1) < 0.5 * n)[:, None]
    xs_t = jnp.asarray(particles).transpose(0, 2, 1)
    with pltpu.force_tpu_interpret_mode():
        gathered = resample_gather_walk(jnp.asarray(u), w_j, xs_t)
    xp = jnp.where(do[..., None], gathered, xs_t)
    carry = jnp.where(do, -jnp.log(jnp.float32(n)), jnp.asarray(lw))
    params = (models_j.A[:, 0, 0], jnp.sqrt(models_j.Q[:, 0, 0]), models_j.B[:, 0], models_j.R)
    with pltpu.force_tpu_interpret_mode():
        new_j, log_norm_j, lse_j, ess_j = jax_fused_step(
            _jax_lg_injected, 0, y, params, (xp[:, 0], jnp.asarray(normals[0])), n_normals=1,
            normalize=True, carry_logw=carry)

    anc = sorted_ancestors(torch.from_numpy(u), torch.exp(torch.from_numpy(lw))).numpy()
    agree = anc == np.asarray(jax.vmap(jax_inverse_cdf)(jnp.asarray(u), w_j))
    agree |= ~np.asarray(do)  # rows that did not fire keep their particles
    assert np.mean(~agree) < 1e-3
    rows = agree.all(1)
    assert rows.sum() >= m - 2
    assert int(np.asarray(do).sum()) == {"half": m // 2, "none": 0, "all": m}[fire]
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.particles.numpy()[..., 0][agree], np.asarray(new_j[0])[agree], **tol)
    np.testing.assert_allclose(out.log_weights.numpy()[rows], np.asarray(log_norm_j)[rows], **tol)
    np.testing.assert_allclose(out.log_mean.numpy()[rows], np.asarray(lse_j)[rows, 0], **tol)
    np.testing.assert_allclose(out.ess.numpy()[rows], np.asarray(ess_j)[rows, 0], **tol)


@pytest.mark.parametrize("inner", INNER)
def test_pf_log_likelihood_matches_kalman_and_jax(inner):
    """Distributional tier: PF log Z at θ* over 64 independent rows, N=256,
    T=40. (a) Against the port's Kalman log Z of the filter's own target —
    the Kalman filter predicts x₁ from (x0, Σ0) while the PF draws x₁ ~
    N(x0, Σ0), so the oracle runs from Σ0' = (Σ0 − Q)/A², whose prediction
    is N(0, 1) — by the delta method: E[Ẑ] = Z gives mean + var/2 ≈ log Z,
    within 5 standard errors of that estimate. (b) Against the JAX batched
    filter with the same configuration (XLA route): means within 5 combined
    standard errors."""
    m, n, t = 64, 256, 40
    y = _series(t)
    theta = np.tile(np.array(THETA, np.float32), (m, 1))
    cfg = tsmc.PFConfig(*inner)
    _, lw, lz_t = tbf.batched_log_likelihood(torch.Generator().manual_seed(0),
                                             tsmc.lg_model(torch.from_numpy(theta)), n, m,
                                             torch.from_numpy(y), cfg)
    np.testing.assert_allclose(torch.logsumexp(lw, 1).numpy(), 0.0, atol=1e-5)
    a, q, r = THETA
    target = tsmc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2,
                                             device="cpu")
    _, kz = tsmc.kalman_log_likelihood(target, torch.from_numpy(y))
    lz = lz_t.double().numpy()
    assert np.all(np.isfinite(lz))
    var = lz.var(ddof=1)
    se = math.sqrt(var / m + var**2 / (2 * (m - 1)))
    assert abs(lz.mean() + var / 2 - kz.item()) < 5 * se, (lz.mean(), var, kz.item())

    _, _, lz_j = jax_loglik(jax.random.key(0), jax.vmap(jsmc.lg_model)(jnp.asarray(theta)), n, m,
                            jnp.asarray(y), jsmc.PFConfig(*inner, "off"))
    lz_j = np.asarray(lz_j, np.float64)
    se2 = math.sqrt(lz_j.var(ddof=1) / m + var / m)
    assert abs(lz_j.mean() - lz.mean()) < 5 * se2, (lz_j.mean(), lz.mean(), se2)


@pytest.mark.parametrize("model", ["hp", "sv"])
def test_pf_log_likelihood_matches_exact_oracle(model):
    """Distributional tier for the 2-d LG and the SV instances, as
    chip_smoke.py's filters phase checks them on the GPU: PF log Z over 64
    rows, N=256, T=40, by the delta method within 5 standard errors, against
    the exact log Z of the filter's own target. Hodrick–Prescott (stratified)
    against the Kalman filter from x0' = A⁻¹x0, Σ0' = A⁻¹(Σ0 − Q)A⁻ᵀ; SV
    (systematic) against chip_smoke.py's point-mass grid filter, which gives
    the same log Z on a grid twice as fine (to 1e-8) and a log Z at least
    ten standard errors away for σ² in place of σ."""
    import chip_smoke

    m, n, t = 64, 256, 40
    if model == "hp":
        y = torch.from_numpy(_series(t))
        hp = tsmc.hodrick_prescott(1600.0, y, init_cov=1.0)
        cloud = tsmc.models.LinearGaussianModel(**{
            k: getattr(hp, k).expand((m,) + tuple(getattr(hp, k).shape)).contiguous()
            for k in ("A", "B", "Q", "R", "x0", "sigma0")})
        inner = ("stratified", 1.0)
        a_inv = torch.linalg.inv(hp.A)
        target = tsmc.multivariate_linear_gaussian(hp.A, hp.B, hp.Q, hp.R, X0=a_inv @ hp.x0,
                                                   Sigma0=a_inv @ (hp.sigma0 - hp.Q) @ a_inv.T)
        exact = tsmc.kalman_log_likelihood(target, y)[1].item()
    else:
        mu, phi, sig = -1.0, 0.95, 0.3
        ys = chip_smoke.sv_series(mu, phi, sig, t)
        y = torch.from_numpy(ys)
        cloud = tsmc.sv_model(torch.tensor([mu, phi, sig]).expand(m, 3))
        inner = ("systematic", 1.0)
        exact = chip_smoke.sv_grid_log_z(ys, mu, phi, sig)
        assert abs(chip_smoke.sv_grid_log_z(ys, mu, phi, sig, points=4001) - exact) < 1e-8
    _, lw, lz_t = tbf.batched_log_likelihood(torch.Generator().manual_seed(0), cloud, n, m, y,
                                             tsmc.PFConfig(*inner))
    np.testing.assert_allclose(torch.logsumexp(lw, 1).numpy(), 0.0, atol=1e-5)
    lz = lz_t.double().numpy()
    assert np.all(np.isfinite(lz))
    var = lz.var(ddof=1)
    se = math.sqrt(var / m + var**2 / (2 * (m - 1)))
    assert abs(lz.mean() + var / 2 - exact) < 5 * se, (lz.mean(), var, exact)
    if model == "sv":
        wrong = chip_smoke.sv_grid_log_z(ys, mu, phi, sig * sig)
        assert abs(wrong - exact) > 10 * se, (wrong, exact, se)


# seed spread (sd over seeds 0..63 and 64..191, two batches) of the
# density-tempered posterior mean at M=64, N=256, T=40, chain=2 on the CPU,
# per component of θ = (A, Q, R): the largest of the JAX package's and the
# port's in either batch
SMALL_SD = np.array([0.0829, 0.1253, 0.1211])


@pytest.mark.parametrize("inner", [("systematic", 1.0), ("stratified", 0.5)])
def test_density_tempered_posterior_matches_jax(inner):
    """Posterior tier: the mean over 8 seeds of the port's density-tempered
    posterior mean against the same for the JAX package, at M=64, N=256,
    T=40, chain=2. Tolerance: 5 standard errors of the difference of two
    8-seed means, 5·sd·√(2/8), with sd the measured seed spread above."""
    m, n, t, chain, seeds = 64, 256, 40, 2, 8
    y = _series(t)
    cfg = dict(n_particles=n, n_theta=m, chain=chain, ess_threshold=0.5)
    jax_sampler = jsmc.SMC2(jsmc.lg_model, _jax_prior(),
                            jsmc.SMCConfig(**cfg, inner=jsmc.PFConfig(*inner)))
    port = tsmc.SMC2(tsmc.lg_model, prior_from_spec(LG_PRIOR, device="cpu"),
                     tsmc.SMCConfig(**cfg, inner=tsmc.PFConfig(*inner)))
    jax_means, port_means = [], []
    for s in range(seeds):
        st_j, _ = jsmc.density_tempered(jax_sampler, jax.random.key(s), jnp.asarray(y))
        jax_means.append(np.asarray(jsmc.expected_parameters(st_j)))
        st, trace = tsmc.density_tempered(port, torch.Generator().manual_seed(s),
                                          torch.from_numpy(y))
        assert trace[-1].xi == 1.0 and all(a.xi < b.xi for a, b in zip(trace, trace[1:]))
        assert st.t == t and math.isfinite(st.ess.item())
        port_means.append(tsmc.expected_parameters(st).numpy())
    diff = np.mean(port_means, 0) - np.mean(jax_means, 0)
    tol = 5 * SMALL_SD * math.sqrt(2 / seeds)
    assert np.all(np.abs(diff) <= tol), (diff, tol)


@pytest.mark.parametrize("inner", [("systematic", 1.0), ("stratified", 0.5)])
def test_density_tempered_inner_step_count(monkeypatch, inner):
    """The count chip_smoke.py checks on the GPU: T − 1 inner steps for the
    initial filter and chain·(T − 1) for each stage that rejuvenates (every
    stage but the clamped last), each one pass of a resample kernel and the
    propagate kernel (``_pf_step_from_draws``)."""
    calls = []
    step = tbf._pf_step_from_draws
    monkeypatch.setattr(tbf, "_pf_step_from_draws", lambda *a: calls.append(1) or step(*a))
    t, chain = 20, 2
    sampler = tsmc.SMC2(tsmc.lg_model, prior_from_spec(LG_PRIOR, device="cpu"),
                        tsmc.SMCConfig(n_particles=64, n_theta=16, chain=chain,
                                       inner=tsmc.PFConfig(*inner)))
    _, trace = tsmc.density_tempered(sampler, torch.Generator().manual_seed(1),
                                     torch.from_numpy(_series(t)))
    moves = sum(s.xi < 1.0 for s in trace)
    assert moves >= 1
    assert len(calls) == (t - 1) * (1 + chain * moves)


def test_elastic_active_n_raises():
    """The elastic live-particle count is ported (a 0-d tensor is taken);
    a count outside [1, N] raises."""
    models = tsmc.lg_model(torch.tensor(THETA).expand(4, 3))
    y = torch.from_numpy(_series(5))
    _, lw, _ = tbf.batched_log_likelihood(torch.Generator().manual_seed(0), models, 64, 4, y,
                                          active_n=torch.tensor(32))
    assert torch.all(lw[:, 32:] == -torch.inf)
    for bad in (0, 65):
        with pytest.raises(ValueError, match="active_n"):
            tbf.batched_log_likelihood(torch.Generator().manual_seed(0), models, 64, 4, y,
                                       active_n=torch.tensor(bad))


def test_entry_points_default_to_the_card():
    """interop's constructors, and the model constructors given numbers, put
    tensors on the card unless asked for another device; a model built from a
    tensor lies on its device; a prior row with the wrong number of
    parameters is refused."""
    for fn in (interop.from_numpy_state, interop.from_numpy_model, interop.prior_from_spec,
               tsmc.univariate_linear_gaussian, tsmc.multivariate_linear_gaussian,
               tsmc.unobserved_components, tsmc.hodrick_prescott, tsmc.stochastic_volatility):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for model in (tsmc.univariate_linear_gaussian(0.5, 1.0, 0.9, 0.8, device="meta"),
                  tsmc.multivariate_linear_gaussian(np.eye(2), [1.0, 0.0], 0.5, 0.8,
                                                    device="meta"),
                  tsmc.hodrick_prescott(1600.0, [1.0, 1.1], device="meta")):
        assert {getattr(model, k).device.type for k in ("A", "B", "Q", "R", "x0", "sigma0")} \
            == {"meta"}
    assert tsmc.stochastic_volatility(device="meta").mu.device.type == "meta"
    cpu = tsmc.univariate_linear_gaussian(torch.tensor(0.5), 1.0, 0.9, 0.8)
    assert {getattr(cpu, k).device.type for k in ("A", "B", "Q", "R", "x0", "sigma0")} == {"cpu"}
    with pytest.raises(ValueError, match="takes 4"):
        prior_from_spec([("truncated_normal", 0.0, 1.0)], device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        prior_from_spec([("gamma", 1.0, 1.0)], device="cpu")
