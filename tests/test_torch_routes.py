"""The port's widened inner filter against the JAX package: the resamplers
(``residual``, ``residual_systematic``, ``metropolis``, ``_counts_to_ancestors``,
``normalize``), K2's plain LG update at dx ≥ 3, the elastic live-count step
(``active_n``), the guided proposal's increment, and every inner route's
log Z against the exact Kalman log Z. JAX draws with threefry and the port
with PyTorch's generators, so the exact tier takes JAX's draws (its offsets,
uniforms, proposal draws) or numpy's into both packages."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import sequential_monte_carlo_tpu as jsmc
from sequential_monte_carlo_tpu.kernels.propagate_pallas import fused_elementwise_step as jax_fused_step
from sequential_monte_carlo_tpu.models.linear_gaussian import _lg_update as jax_lg_update
from sequential_monte_carlo_tpu.ops import batched_filter as jbf
from sequential_monte_carlo_tpu.ops import resampling as jres
from sequential_monte_carlo_tpu.ops import weights as jweights
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.kernels.propagate import _lg_source, fused_elementwise_step
from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import sorted_ancestors
from sequential_monte_carlo_tpu_torch.models.linear_gaussian import LG_UPDATES, _lg_update
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf
from sequential_monte_carlo_tpu_torch.ops import resampling as tres

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 rounding of exp/log in another library
THETA = (0.5, 0.9, 0.8)  # θ* = (A, Q, R)
N_RES = 64


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


def _weights():
    rng = np.random.default_rng(0)
    w = rng.gamma(1.0, size=N_RES)
    return (w / w.sum()).astype(np.float32)


def _jax_injected(update, n_state):
    """A JAX update reading its normals from pass-through state planes
    (interpret mode's in-kernel PRNG is a stub)."""
    def f(par, y, state, normals):
        new, logw = update(par, y, state[:n_state], state[n_state:])
        return tuple(new) + tuple(state[n_state:]), logw
    return f


# -- resamplers ---------------------------------------------------------------

def test_counts_to_ancestors_matches_jax():
    """The same offspring counts (summing to n) give JAX's sorted ancestors."""
    rng = np.random.default_rng(1)
    for n in (1, 7, 64):
        counts = rng.multinomial(n, np.full(10, 0.1)).astype(np.int32)
        ours = tres._counts_to_ancestors(torch.from_numpy(counts)[None], n)[0].numpy()
        ref = np.asarray(jres._counts_to_ancestors(jnp.asarray(counts), n))
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("key", [0, 1, 2, 3])
def test_residual_matches_jax_from_the_same_uniforms(key):
    """Residual resampling from JAX's own uniforms (the first draw of its
    key) gives JAX's ancestors; both keep the floor(n·w) copies, and a
    second, batched row agrees too."""
    w = _weights()
    k = jax.random.key(key)
    u = np.array(jax.random.uniform(k, (N_RES,)))
    ref = np.asarray(jres.residual(k, jnp.asarray(w)))
    ours = tres._residual_from_uniforms(torch.from_numpy(u)[None].expand(2, -1),
                                        torch.from_numpy(w)[None].expand(2, -1)).numpy()
    np.testing.assert_array_equal(ours[0], ref)
    np.testing.assert_array_equal(ours[1], ref)
    counts = np.bincount(ours[0], minlength=N_RES)
    assert counts.sum() == N_RES and np.all(counts >= np.floor(N_RES * w))


def test_residual_systematic_is_systematic():
    """From the same generator state, ``residual_systematic`` ≡ ``systematic``."""
    w = torch.from_numpy(_weights()).expand(8, -1)
    for seed in range(5):
        a = tres.residual_systematic(torch.Generator().manual_seed(seed), w)
        b = tres.systematic(torch.Generator().manual_seed(seed), w)
        assert torch.equal(a, b)


def _offspring(scheme, trials=2000):
    """Offspring counts of ``trials`` rows of the same weights."""
    w = torch.from_numpy(_weights()).expand(trials, -1).contiguous()
    anc = tres.resample(torch.Generator().manual_seed(42), w, scheme=scheme).long()
    return torch.zeros((trials, N_RES), dtype=torch.int64).scatter_add_(
        1, anc, torch.ones_like(anc)).numpy()


@pytest.mark.parametrize("scheme", ["multinomial", "systematic", "stratified", "residual",
                                    "residual_systematic"])
def test_resamplers_unbiased(scheme):
    """E[offspring] = n·w within 6 standard errors (JAX's test_unbiased)."""
    counts = _offspring(scheme)
    se = counts.std(0).max() / math.sqrt(counts.shape[0])
    np.testing.assert_allclose(counts.mean(0), N_RES * _weights(), atol=max(6 * se, 0.15))
    assert np.all(counts.sum(1) == N_RES)


def test_metropolis_approximately_unbiased():
    """The metropolis resampler tracks n·w (JAX's test: corr > 0.99, within
    1 offspring), its bias decaying in the chain length."""
    counts = _offspring("metropolis")
    expected = N_RES * _weights()
    got = counts.mean(0)
    assert np.corrcoef(got, expected)[0, 1] > 0.99
    np.testing.assert_allclose(got, expected, atol=1.0)


def test_normalize_and_reweight_match_jax():
    """``normalize`` (alias ``reweight``) ≡ JAX's on batched log-weights,
    an all −inf row included."""
    rng = np.random.default_rng(2)
    lw = (3.0 * rng.standard_normal((4, 50))).astype(np.float32)
    lw[1, :10] = -np.inf
    lw[2] = -np.inf
    ours = tsmc.normalize(torch.from_numpy(lw))
    ref = jweights.normalize(jnp.asarray(lw))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert tsmc.reweight is tsmc.normalize


# -- K2's LG instances at any dx --------------------------------------------

@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dx", [3, 4, 5])
def test_plain_lg_update_any_dx_matches_pallas_kernel(dx, normalize):
    """K2's plain version of the LG update at dx = 3, 4, 5 (normals consumed
    in order, the fifth at the second Philox counter on the card) against
    the Pallas kernel with JAX's ``_lg_update(dx)`` (interpret mode), fed
    the same normals: planes and log-weights (normalized or raw) to rtol
    1e-5."""
    rng = np.random.default_rng(dx)
    m, n, y = 8, 256, 0.6
    upd = LG_UPDATES[dx]
    p = 2 * dx * dx + dx + 1
    params = rng.uniform(0.1, 0.9, (m, p)).astype(np.float32)
    state = (0.5 * rng.standard_normal((m, dx, n))).astype(np.float32)
    normals = rng.standard_normal((dx, m, n)).astype(np.float32)
    ours = [t.numpy().copy() for t in fused_elementwise_step(
        upd, torch.from_numpy(params), torch.from_numpy(state), torch.tensor(y),
        normals=torch.from_numpy(normals), normalize=normalize)]
    planes = tuple(jnp.asarray(state[:, i]) for i in range(dx))
    planes += tuple(jnp.asarray(z) for z in normals)
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(jax_fused_step(
            _jax_injected(jax_lg_update(dx), dx), 0, y,
            tuple(jnp.asarray(params[:, i]) for i in range(p)), planes, n_normals=dx,
            normalize=normalize))
    ref = [np.stack([np.asarray(q) for q in out[0][:dx]], 1)] + [np.asarray(v) for v in out[1:]]
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dx", [1, 2, 3, 6])
def test_lg_instances_cover_any_dx(dx):
    """LG_UPDATES has an instance at every dx, with dx normals, whose plain
    update is ``_lg_update(dx)``; a dx-state model filters through it. The
    generated Triton source (dx ≥ 3) is valid Python, loads and stores the
    dx planes, and draws normals past the fourth at further Philox counters."""
    import ast

    upd = LG_UPDATES[dx]
    assert upd.n_normals == dx and upd.plain is _lg_update(dx) and upd.triton == f"lg{dx}"
    a = 0.5 * np.eye(dx, dtype=np.float32)
    model = tsmc.multivariate_linear_gaussian(a, np.ones(dx, np.float32), 0.3, 0.8, device="cpu")
    assert model.update is upd
    if dx >= 3:
        src = _lg_source(dx)
        ast.parse(src)
        assert src.count("tl.store(new +") == dx and src.count("tl.load(st +") == dx
        assert src.count("tl.philox") == (dx + 3) // 4 - 1
    with pytest.raises(KeyError):
        LG_UPDATES[0]


# -- the elastic live count --------------------------------------------------

@pytest.mark.parametrize("adaptive", [1.0, 0.5])
@pytest.mark.parametrize("scheme", ["systematic", "stratified"])
def test_elastic_step_matches_jax_pieces(scheme, adaptive):
    """Exact tier: one elastic step (active_n = 100 of N = 256, the dead
    tail at −inf) from the same cloud, weights, offsets and normals. The
    live-prefix grid is JAX's ``_elastic_sorted_u`` bit for bit; the
    ancestors (K3's plain version) equal JAX's XLA route's on all but < 1e-3
    of slots (f64 vs f32 cumsum) and stay below active_n; on rows where
    they agree, log-weights, evidence and ESS match JAX's raw fused step
    (interpret mode, injected normals) with the increment zeroed on dead
    slots and ``_row_normalize``, to rtol 1e-5; the tail stays exactly −inf
    and the evidence is the log-mean over the live slots."""
    m, n, active, y = 16, 256, 100, 0.7
    rng = np.random.default_rng(5)
    conc = np.where(np.arange(m) < m // 2, 3.0, 0.1)[:, None]
    a = conc * rng.standard_normal((m, n))
    a[:, active:] = -np.inf
    lw = (a - np.log(np.exp(a).sum(-1, keepdims=True))).astype(np.float32)
    particles = rng.standard_normal((m, n, 1)).astype(np.float32)
    normals = rng.standard_normal((1, m, n)).astype(np.float32)
    theta = np.tile(np.array(THETA, np.float32), (m, 1))
    theta[:, 0] += np.linspace(-0.2, 0.2, m, dtype=np.float32)
    cfg_j = jsmc.PFConfig(scheme, adaptive, "off")
    k_res = jax.random.key(9)
    u_j = np.asarray(jbf._elastic_sorted_u(k_res, cfg_j, m, n, jnp.int32(active), jnp.float32))
    off = np.array(jax.random.uniform(k_res, (m, 1) if scheme == "systematic" else (m, n)))
    u = tbf._elastic_sorted_u(torch.from_numpy(off), n, active)
    np.testing.assert_array_equal(u.numpy(), u_j)

    out = tbf._pf_step_from_draws(
        torch.from_numpy(off), torch.from_numpy(normals), tsmc.lg_model(torch.from_numpy(theta)),
        torch.from_numpy(np.ascontiguousarray(particles.transpose(0, 2, 1))).transpose(1, 2),
        torch.from_numpy(lw), torch.tensor(y), tsmc.PFConfig(scheme, adaptive),
        active_n=active)

    w_j = jnp.exp(jnp.asarray(lw))
    cdf = jnp.cumsum(w_j, axis=-1)
    cdf = cdf / cdf[..., -1:]
    anc_j = np.asarray(jax.vmap(lambda c, uu: jnp.clip(jnp.searchsorted(c, uu, side="left"),
                                                       0, n - 1))(cdf, jnp.asarray(u_j)))
    anc = sorted_ancestors(u, torch.exp(torch.from_numpy(lw))).numpy()
    assert anc.max() < active
    live = np.arange(n)[None, :] < active
    log_n = np.log(np.float32(active))
    reset = np.where(live, -log_n, -np.inf).astype(np.float32)
    fire = np.ones(m, bool)
    if adaptive < 1.0:
        ess = 1.0 / np.sum(np.exp(lw.astype(np.float64)) ** 2, -1)
        fire = ess < adaptive * active
        assert 0 < fire.sum() < m
    agree = (anc == anc_j) | ~fire[:, None]
    assert np.mean(~agree) < 1e-3
    rows = agree.all(1)
    assert rows.sum() >= m - 2
    xs = particles[..., 0]
    xp = np.where(fire[:, None], np.take_along_axis(xs, anc_j, 1), xs)
    lw_pre = np.where(fire[:, None], reset, lw)
    p = tsmc.lg_model(torch.from_numpy(theta)).fused_params().numpy()
    with pltpu.force_tpu_interpret_mode():
        new_j, incr_j = jax_fused_step(
            _jax_injected(jax_lg_update(1), 1), 0, y, tuple(jnp.asarray(p[:, i]) for i in range(4)),
            (jnp.asarray(xp), jnp.asarray(normals[0])), n_normals=1, normalize=False)
    incr_j = jnp.where(jnp.asarray(live), incr_j, 0.0)
    log_norm_j, log_mean_j, ess_j = jbf._row_normalize(jnp.asarray(lw_pre) + incr_j)
    np.testing.assert_allclose(out.particles.numpy()[..., 0][agree], np.asarray(new_j[0])[agree],
                               **TOL)
    got_lw = out.log_weights.numpy()
    assert np.all(got_lw[:, active:] == -np.inf) and np.all(np.isfinite(got_lw[:, :active]))
    np.testing.assert_allclose(got_lw[rows][:, :active], np.asarray(log_norm_j)[rows][:, :active],
                               **TOL)
    np.testing.assert_allclose(out.log_mean.numpy()[rows], np.asarray(log_mean_j)[rows], **TOL)
    np.testing.assert_allclose(out.ess.numpy()[rows], np.asarray(ess_j)[rows], **TOL)


def test_elastic_init_and_its_errors():
    """The elastic init: dead slots at exactly −inf, the rows normalized
    over the live slots, the evidence their log-mean over active_n (not N);
    an active_n outside [1, N] raises, as does the auxiliary filter with
    one (JAX's error)."""
    m, n, active = 8, 64, 24
    models = tsmc.lg_model(torch.tensor(THETA).expand(m, 3))
    init = tbf.batched_pf_init(torch.Generator().manual_seed(0), models, n, m,
                               torch.tensor(0.3), active_n=active)
    assert torch.all(init.log_weights[:, active:] == -torch.inf)
    np.testing.assert_allclose(torch.logsumexp(init.log_weights, 1).numpy(), 0.0, atol=1e-6)
    x = init.particles[:, :, 0]
    logw = models.observation_distribution(x.T[..., None]).log_prob(torch.tensor(0.3)).T
    ref = torch.logsumexp(logw[:, :active], 1) - math.log(active)
    torch.testing.assert_close(init.log_mean, ref, **TOL)
    for bad in (0, n + 1):
        with pytest.raises(ValueError, match="active_n"):
            tbf.batched_pf_init(torch.Generator().manual_seed(0), models, n, m,
                                torch.tensor(0.3), active_n=bad)
    with pytest.raises(ValueError, match="apf"):
        tbf.batched_pf_step(torch.Generator().manual_seed(1), models, init.particles,
                            init.log_weights, torch.tensor(0.2),
                            tsmc.PFConfig(algorithm="apf"), active_n=active)


# -- the guided proposal -----------------------------------------------------

def _widened(kind, scale):
    """The transition with its scale widened ``scale``-fold: (the port's
    proposal, JAX's per-θ step)."""
    if kind == "lg1":
        port = tsmc.Proposal(
            initial=lambda mm: mm.initial_distribution(),
            step=lambda mm, xp: tsmc.Product(tsmc.Normal(mm.A[..., 0, :] * xp,
                                                         scale * torch.sqrt(mm.Q[..., 0, :]))))

        def jstep(mm, xp):
            return jsmc.Product(jsmc.Normal(mm.A[..., 0, :] * xp, scale * jnp.sqrt(mm.Q[..., 0, :])))
    else:
        port = tsmc.Proposal(
            initial=lambda mm: mm.initial_distribution(),
            step=lambda mm, xp: tsmc.MvNormal((mm.A @ xp[..., None])[..., 0],
                                              scale**2 * mm.Q))

        def jstep(mm, xp):
            return jsmc.MvNormal(jnp.einsum("ij,...j->...i", mm.A, xp), scale**2 * mm.Q)
    return port, jstep


@pytest.mark.parametrize("kind", ["lg1", "lg2"])
def test_guided_increment_matches_jax_prop_one(kind):
    """The guided step's increment log g(y|x′) + log f(x′|x) − log q(x′|x)
    from JAX's own proposal draws x′ (its ``prop_one``, vmapped over θ)
    equals the port's on the same resampled states and draws, rtol 1e-5."""
    m, n, y = 6, 128, 0.4
    rng = np.random.default_rng(8)
    if kind == "lg1":
        theta = np.tile(np.array(THETA, np.float32), (m, 1))
        theta[:, 0] += np.linspace(-0.2, 0.2, m, dtype=np.float32)
        models_j = jax.vmap(jsmc.lg_model)(jnp.asarray(theta))
        models_t = tsmc.lg_model(torch.from_numpy(theta))
        dx = 1
    else:
        a = np.array([[0.9, 0.1], [0.0, 0.7]], np.float32)
        q = np.array([[0.5, 0.1], [0.1, 0.3]], np.float32)
        one = jsmc.multivariate_linear_gaussian(a, np.array([1.0, 0.5], np.float32), q, 0.8)
        models_j = jax.tree.map(lambda v: jnp.broadcast_to(v, (m,) + v.shape), one)
        models_t = tsmc.models.LinearGaussianModel(**{
            k: torch.from_numpy(np.array(getattr(models_j, k)))
            for k in ("A", "B", "Q", "R", "x0", "sigma0")})
        dx = 2
    port, jstep = _widened(kind, 1.5)
    xp = rng.standard_normal((m, n, dx)).astype(np.float32)

    def prop_one(k, mod, xp_):
        q = jstep(mod, xp_)
        xn = q.sample(k)
        inc = (mod.observation_distribution(xn).log_prob(y)
               + mod.transition_distribution(xp_).log_prob(xn) - q.log_prob(xn))
        return xn, inc

    xn_j, inc_j = jax.vmap(prop_one)(jax.random.split(jax.random.key(4), m), models_j,
                                     jnp.asarray(xp))
    states = torch.from_numpy(xp).transpose(0, 1)  # (N, M, dx)
    xn = torch.from_numpy(np.array(xn_j)).transpose(0, 1)
    inc = tbf._guided_increment(models_t, port.step(models_t, states), states, xn,
                                torch.tensor(y)).T
    np.testing.assert_allclose(inc.numpy(), np.asarray(inc_j), **TOL)


# -- every route's log Z against the Kalman filter ---------------------------

ROUTES = {
    "multinomial": dict(inner=("multinomial", 1.0)),
    "residual": dict(inner=("residual", 1.0)),
    "residual_systematic": dict(inner=("residual_systematic", 1.0)),
    "metropolis": dict(inner=("metropolis", 1.0)),
    "residual_adaptive": dict(inner=("residual", 0.5)),
    "guided": dict(inner=("systematic", 1.0), guided=True),
    "guided_stratified_adaptive": dict(inner=("stratified", 0.5), guided=True),
    "elastic_systematic": dict(inner=("systematic", 1.0), active_n=192),
    "elastic_stratified_adaptive": dict(inner=("stratified", 0.5), active_n=192),
    "elastic_multinomial": dict(inner=("multinomial", 1.0), active_n=192),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_inner_routes_match_kalman(route):
    """Distributional tier: PF log Z at θ* over 64 rows, N=256 (or 192 live
    of 256), T=40, for each inner route, by the delta method (E[Ẑ] = Z gives
    mean + var/2 ≈ log Z) within 5 standard errors of the Kalman log Z of
    the filter's own target (Σ0' = (Σ0 − Q)/A², whose prediction is the
    filter's N(0, 1) draw of x₁). The guided proposal widens the transition
    1.5-fold, so its importance correction does not cancel."""
    spec = ROUTES[route]
    m, n, t = 64, 256, 40
    y = _series(t)
    proposal = _widened("lg1", 1.5)[0] if spec.get("guided") else None
    cfg = tsmc.PFConfig(*spec["inner"], proposal=proposal)
    _, lw, lz_t = tbf.batched_log_likelihood(torch.Generator().manual_seed(0),
                                             tsmc.lg_model(torch.tensor(THETA).expand(m, 3)),
                                             n, m, torch.from_numpy(y), cfg,
                                             active_n=spec.get("active_n"))
    np.testing.assert_allclose(torch.logsumexp(lw, 1).numpy(), 0.0, atol=1e-5)
    if "active_n" in spec:
        assert torch.all(lw[:, spec["active_n"]:] == -torch.inf)
    a, q, r = THETA
    target = tsmc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2,
                                             device="cpu")
    kz = tsmc.kalman_log_likelihood(target, torch.from_numpy(y))[1].item()
    lz = lz_t.double().numpy()
    assert np.all(np.isfinite(lz))
    var = lz.var(ddof=1)
    se = math.sqrt(var / m + var**2 / (2 * (m - 1)))
    assert abs(lz.mean() + var / 2 - kz) < 5 * se, (lz.mean(), var, kz)


@pytest.mark.parametrize("route,kernels", [
    (("systematic", 1.0, None), {"count"}),
    (("residual_systematic", 1.0, None), {"count"}),
    (("stratified", 1.0, None), {"sorted"}),
    (("multinomial", 1.0, None), set()),
    (("residual", 1.0, None), set()),
    (("metropolis", 1.0, None), set()),
    (("systematic", 1.0, 48), {"sorted"}),
    (("residual", 1.0, 48), {"sorted"}),
    (("multinomial", 1.0, 48), set()),
])
def test_routes_take_their_kernels(monkeypatch, route, kernels):
    """Which resample kernel each scheme takes (K1 by offsets, K3 on a
    sorted grid, every elastic sorted grid on K3, the others none), and that
    every route's propagate is the model's fused step — without the
    normalize under ``active_n``."""
    calls = {"count": 0, "sorted": 0, "propagate": []}
    orig_count, orig_sorted = tbf.resample_gather, tbf.resample_gather_sorted
    monkeypatch.setattr(tbf, "resample_gather", lambda *a: (
        calls.__setitem__("count", calls["count"] + 1), orig_count(*a))[1])
    monkeypatch.setattr(tbf, "resample_gather_sorted", lambda *a: (
        calls.__setitem__("sorted", calls["sorted"] + 1), orig_sorted(*a))[1])
    models = tsmc.lg_model(torch.tensor(THETA).expand(8, 3))
    orig_prop = type(models).fused_propagate_reweight

    def prop(self, *a, **kw):
        calls["propagate"].append(kw.get("normalize", True))
        return orig_prop(self, *a, **kw)

    monkeypatch.setattr(type(models), "fused_propagate_reweight", prop)
    scheme, thr, active = route
    tbf.batched_log_likelihood(torch.Generator().manual_seed(0), models, 64, 8,
                               torch.from_numpy(_series(6)), tsmc.PFConfig(scheme, thr),
                               active_n=active)
    assert {k for k in ("count", "sorted") if calls[k]} == kernels
    for k in kernels:
        assert calls[k] == 5
    assert calls["propagate"] == [active is None] * 5
