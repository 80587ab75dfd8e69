"""The PyTorch port's linear-Gaussian and SV families against the JAX
package on the same inputs (made with numpy from a seed): the distributions
they need (LogNormal, TruncatedNormal, MvNormal with Hodrick–Prescott's
singular Q), the models' densities, the kernel-2 update functions and their
fused step (the Pallas builder in TPU interpret mode, whose in-kernel PRNG
gives zeros, so both sides read injected normals), ``fused_prep``, and the
Kalman filter."""
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
from sequential_monte_carlo_tpu.models.stochastic_volatility import _sv_update as jax_sv_update
from sequential_monte_carlo_tpu.models.ucsv import _ucsv_update as jax_ucsv_update
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.interop import from_numpy_model, prior_from_spec
from sequential_monte_carlo_tpu_torch.kernels.propagate import fused_elementwise_step
from sequential_monte_carlo_tpu_torch.models.linear_gaussian import LG_UPDATES, _lg_update
from sequential_monte_carlo_tpu_torch.models.stochastic_volatility import SV_UPDATE, sv_update
from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE
from sequential_monte_carlo_tpu_torch.ops import kalman as tkal
from sequential_monte_carlo_tpu_torch.utils.struct import struct

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

# f32 elementwise math (exp, log, ndtr, eigh) in another library: a few ulps
TOL = dict(rtol=1e-5, atol=1e-5)
LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
HP_Y = np.array([1.0, 1.1, 1.25, 1.2, 1.4, 1.35, 1.5, 1.45], np.float32)


def _jax_lg_prior():
    f = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    return jsmc.product_distribution([
        jsmc.TruncatedNormal(f(0.0), f(1.0), f(-1.0), f(1.0)),
        jsmc.LogNormal(f(0.0), f(1.0)), jsmc.LogNormal(f(0.0), f(1.0))])


def _fields(model_j):
    return {k: np.asarray(getattr(model_j, k)) for k in ("A", "B", "Q", "R", "x0", "sigma0")}


def _pair(kind, rng):
    """(port distribution, JAX distribution, inputs x) of one kind."""
    if kind == "lognormal":
        mu, sig = rng.normal(size=4).astype(np.float32), rng.uniform(0.5, 2, 4).astype(np.float32)
        x = rng.normal(1.0, 1.5, (50, 4)).astype(np.float32)  # some ≤ 0
        return (tsmc.LogNormal(torch.from_numpy(mu), torch.from_numpy(sig)),
                jsmc.LogNormal(jnp.asarray(mu), jnp.asarray(sig)), x)
    if kind == "truncated_normal":
        loc, sc = rng.normal(size=4).astype(np.float32), rng.uniform(0.5, 2, 4).astype(np.float32)
        lo, hi = (loc - 1.0).astype(np.float32), (loc + rng.uniform(0.5, 2, 4)).astype(np.float32)
        x = rng.normal(0.0, 2.0, (50, 4)).astype(np.float32)  # some outside
        args = (loc, sc, lo, hi)
        return (tsmc.TruncatedNormal(*map(torch.from_numpy, args)),
                jsmc.TruncatedNormal(*map(jnp.asarray, args)), x)
    if kind == "lg_prior":
        x = np.abs(rng.normal(0.0, 1.0, (50, 3))).astype(np.float32)
        x[::7, 0] = 1.5  # outside the truncation
        return prior_from_spec(LG_PRIOR, device="cpu"), _jax_lg_prior(), x
    if kind == "mvnormal":
        a = rng.normal(size=(3, 3)).astype(np.float32)
        cov = (a @ a.T + 0.5 * np.eye(3)).astype(np.float32)
        mean = rng.normal(size=3).astype(np.float32)
        x = rng.normal(size=(50, 3)).astype(np.float32)
        return (tsmc.MvNormal(torch.from_numpy(mean), torch.from_numpy(cov)),
                jsmc.MvNormal(jnp.asarray(mean), jnp.asarray(cov)), x)
    # Hodrick–Prescott's singular Q: the density on the support subspace
    q = np.array([[1.0 / 1600.0, 0.0], [0.0, 0.0]], np.float32)
    mean = rng.normal(size=2).astype(np.float32)
    x = (mean + rng.normal(0.0, 0.02, (50, 2))).astype(np.float32)
    return (tsmc.MvNormal(torch.from_numpy(mean), torch.from_numpy(q)),
            jsmc.MvNormal(jnp.asarray(mean), jnp.asarray(q)), x)


@pytest.mark.parametrize("kind", ["lognormal", "truncated_normal", "lg_prior", "mvnormal",
                                  "mvnormal_singular"])
def test_distributions_match_jax(kind):
    """log_prob to a few f32 ulps (rtol 1e-5), in_support exactly."""
    ours, ref, x = _pair(kind, np.random.default_rng(0))
    np.testing.assert_allclose(ours.log_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.log_prob(jnp.asarray(x))), **TOL)
    np.testing.assert_array_equal(ours.in_support(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref.in_support(jnp.asarray(x))))


def test_samples_follow_the_distributions():
    """Moments at 40k draws within Monte-Carlo error: TruncatedNormal(0, 1,
    −1, 1) (mean 0, var 0.291125), LogNormal(0, 1) (mean e^½), and the
    singular MvNormal (covariance Q, its null direction never moves)."""
    gen = torch.Generator().manual_seed(0)
    th = prior_from_spec(LG_PRIOR, device="cpu").sample(gen, (40000,))
    assert th.shape == (40000, 3)
    assert bool(torch.all(prior_from_spec(LG_PRIOR, device="cpu").in_support(th)))
    np.testing.assert_allclose(th[:, 0].mean().item(), 0.0, atol=0.01)
    np.testing.assert_allclose(th[:, 0].var().item(), 0.291125, rtol=0.03)
    np.testing.assert_allclose(th[:, 1:].mean(0).numpy(), [math.exp(0.5)] * 2, rtol=0.05)
    q = torch.tensor([[0.5, 0.0], [0.0, 0.0]])
    z = tsmc.MvNormal(torch.tensor([1.0, 2.0]), q).sample(gen, (40000,))
    assert bool(torch.all(z[:, 1] == 2.0))
    np.testing.assert_allclose(torch.cov(z.T).numpy(), q.numpy(), atol=0.02)


def _full_rank(kind):
    """(mean, cov, x) on full-rank 2×2 covariances: the JAX test's
    (tests/test_distributions.py:132), or a (4, 2, 2) batch at 6 points each."""
    if kind == "jax_test":
        return (np.array([1.0, -2.0], np.float32), np.array([[2.0, 0.5], [0.5, 1.0]], np.float32),
                np.array([[0.0, 0.0], [1.0, -2.0], [3.0, 1.0]], np.float32))
    rng = np.random.default_rng(5)
    a = rng.normal(size=(4, 2, 2))
    cov = (a @ a.transpose(0, 2, 1) + 0.3 * np.eye(2)).astype(np.float32)
    return (rng.normal(size=(4, 2)).astype(np.float32), cov,
            rng.normal(0.0, 2.0, (6, 4, 2)).astype(np.float32))


@pytest.mark.parametrize("kind", ["jax_test", "batch"])
def test_mvnormal_allow_singular_false_matches_jax(kind):
    """``MvNormal(allow_singular=False)`` (Cholesky only, no eigh): log_prob
    against the JAX package's at allow_singular=False and against the
    port's default to 1e-6; its sample bitwise the default's at one
    generator seed; a singular covariance gives NaN, as in JAX."""
    mean, cov, x = _full_rank(kind)
    fast = tsmc.MvNormal(torch.from_numpy(mean), torch.from_numpy(cov), allow_singular=False)
    auto = tsmc.MvNormal(torch.from_numpy(mean), torch.from_numpy(cov))
    ref = jsmc.MvNormal(jnp.asarray(mean), jnp.asarray(cov), allow_singular=False)
    lp = fast.log_prob(torch.from_numpy(x))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref.log_prob(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), auto.log_prob(torch.from_numpy(x)).numpy(),
                               rtol=1e-6, atol=1e-6)
    draw = fast.sample(torch.Generator().manual_seed(7), (8,))
    assert draw.shape == (8,) + mean.shape and torch.isfinite(draw).all()
    assert torch.equal(draw, auto.sample(torch.Generator().manual_seed(7), (8,)))
    q = np.array([[0.5, 0.0], [0.0, 0.0]], np.float32)
    sing = tsmc.MvNormal(torch.zeros(2), torch.from_numpy(q), allow_singular=False)
    assert np.isnan(float(jsmc.MvNormal(jnp.zeros(2), jnp.asarray(q),
                                        allow_singular=False).log_prob(jnp.asarray([0.3, 0.0]))))
    assert torch.isnan(sing.log_prob(torch.tensor([0.3, 0.0])))
    assert torch.isnan(sing.sample(torch.Generator().manual_seed(7), (2,))).all()


@struct
class _FullRankLG:
    """A user's 2-d linear-Gaussian model that declares its Q full rank."""

    A: torch.Tensor
    Q: torch.Tensor
    allow_singular: bool = False

    def transition_distribution(self, x):
        return tsmc.MvNormal((self.A @ x[..., None])[..., 0], self.Q,
                             allow_singular=self.allow_singular)


def test_broadcast_model_keeps_allow_singular():
    """``allow_singular`` is not a tensor: broadcast_model carries it, on
    the distribution itself and on a model built with it, and the bank's
    rows are the one model's."""
    mean, cov, _ = _full_rank("jax_test")
    d = tsmc.MvNormal(torch.from_numpy(mean), torch.from_numpy(cov), allow_singular=False)
    bank = tsmc.broadcast_model(d, 3)
    assert bank.allow_singular is False and bank.cov.shape == (3, 2, 2)
    model = _FullRankLG(torch.tensor([[0.9, 0.1], [0.0, 0.8]]), torch.from_numpy(cov))
    mbank = tsmc.broadcast_model(model, 3)
    assert mbank.allow_singular is False and mbank.A.shape == (3, 2, 2)
    x = torch.randn((5, 3, 2), generator=torch.Generator().manual_seed(1))
    dist = mbank.transition_distribution(x)
    assert dist.allow_singular is False
    torch.testing.assert_close(dist.log_prob(x), model.transition_distribution(x).log_prob(x))


def _models(kind, m=5):
    """(port model, JAX model vmapped over a θ-cloud of m)."""
    rng = np.random.default_rng(1)
    if kind == "lg":
        theta = np.stack([rng.uniform(-0.9, 0.9, m), rng.uniform(0.2, 2, m),
                          rng.uniform(0.2, 2, m)], 1).astype(np.float32)
        return tsmc.lg_model(torch.from_numpy(theta)), jax.vmap(jsmc.lg_model)(jnp.asarray(theta))
    if kind == "uc":
        theta = np.stack([rng.normal(size=m), rng.uniform(0.2, 2, m),
                          rng.uniform(0.2, 2, m)], 1).astype(np.float32)
        return tsmc.uc_model(torch.from_numpy(theta)), jax.vmap(jsmc.uc_model)(jnp.asarray(theta))
    if kind == "sv":
        theta = np.stack([rng.normal(-1, 0.3, m), rng.uniform(0.5, 0.95, m),
                          rng.uniform(0.1, 0.5, m)], 1).astype(np.float32)
        return tsmc.sv_model(torch.from_numpy(theta)), jax.vmap(jsmc.sv_model)(jnp.asarray(theta))
    hp = jsmc.hodrick_prescott(1600.0, jnp.asarray(HP_Y))
    hp_j = jax.tree.map(lambda a: jnp.broadcast_to(a, (m,) + a.shape), hp)
    return from_numpy_model(_fields(hp_j), device="cpu"), hp_j


@pytest.mark.parametrize("kind", ["lg", "uc", "sv", "hp"])
def test_model_densities_match_jax(kind):
    """Initial, transition and observation log-densities of a θ-cloud model
    at states (N, M, dx), against the JAX model vmapped over M."""
    ours, ref = _models(kind)
    m, dx = 5, 2 if kind == "hp" else 1
    rng = np.random.default_rng(2)
    x = rng.normal(-0.5, 1.0, (7, m, dx)).astype(np.float32)
    xn = rng.normal(-0.5, 1.0, (7, m, dx)).astype(np.float32)
    if kind == "hp":
        xn[..., 1] = x[..., 0]  # on the singular transition's support
    xt = torch.from_numpy(x)
    vm = lambda f: jax.vmap(f, in_axes=(0, 1), out_axes=1)(ref, jnp.asarray(x))  # noqa: E731
    np.testing.assert_allclose(ours.initial_distribution().log_prob(xt).numpy(),
                               np.asarray(vm(lambda md, s: md.initial_distribution().log_prob(s))),
                               **TOL)
    np.testing.assert_allclose(
        ours.transition_distribution(xt).log_prob(torch.from_numpy(xn)).numpy(),
        np.asarray(jax.vmap(lambda md, s, sn: md.transition_distribution(s).log_prob(sn),
                            in_axes=(0, 1, 1), out_axes=1)(ref, jnp.asarray(x), jnp.asarray(xn))),
        **TOL)
    np.testing.assert_allclose(
        ours.observation_distribution(xt).log_prob(torch.tensor(0.7)).numpy(),
        np.asarray(vm(lambda md, s: md.observation_distribution(s).log_prob(0.7))), **TOL)
    draws = ours.initial_distribution().sample(torch.Generator().manual_seed(0), (11,))
    assert draws.shape == (11, m, dx)


@pytest.mark.parametrize("name", ["lg1", "lg2", "sv"])
def test_plain_updates_match_jax(name):
    """The plain per-particle updates ≡ the JAX ones on the same parameters,
    state and normals: states to f32 rounding, log-weights to rtol 1e-5."""
    rng = np.random.default_rng(3)
    m, n = 8, 64
    if name == "sv":
        ours, ref, p, dx = sv_update, jax_sv_update, 3, 1
    else:
        dx = int(name[-1])
        ours, ref, p = _lg_update(dx), jax_lg_update(dx), 2 * dx * dx + dx + 1
    par = [rng.uniform(0.1, 0.9, (m, 1)).astype(np.float32) for _ in range(p)]
    state = [rng.standard_normal((m, n)).astype(np.float32) for _ in range(dx)]
    normals = [rng.standard_normal((m, n)).astype(np.float32) for _ in range(dx)]
    new_t, logw_t = ours(tuple(map(torch.from_numpy, par)), torch.tensor(0.4),
                         tuple(map(torch.from_numpy, state)), tuple(map(torch.from_numpy, normals)))
    new_j, logw_j = ref(tuple(map(jnp.asarray, par)), 0.4, tuple(map(jnp.asarray, state)),
                        tuple(map(jnp.asarray, normals)))
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logw_t.numpy(), np.asarray(logw_j), **TOL)


@pytest.mark.parametrize("kind", ["lg", "hp"])
def test_fused_prep_factors_q(kind):
    """F·Fᵀ = Q (HP's singular Q too), and the kernel's parameter rows are
    (A, F, B, R) in that order."""
    ours, _ = _models(kind)
    F = ours.fused_prep()
    torch.testing.assert_close(F @ F.mT, ours.Q, rtol=1e-5, atol=1e-7)
    dx = ours.state_dim
    params = ours.fused_params()
    m = ours.A.shape[0]
    assert params.shape == (m, 2 * dx * dx + dx + 1) and params.is_contiguous()
    torch.testing.assert_close(params[:, dx * dx:2 * dx * dx].reshape(m, dx, dx), F)
    torch.testing.assert_close(params[:, -1], ours.R)


def _jax_injected(update, n_state):
    """A JAX update reading its normals from pass-through state planes
    (interpret mode's in-kernel PRNG is a stub)."""
    def f(par, y, state, normals):
        new, logw = update(par, y, state[:n_state], state[n_state:])
        return tuple(new) + tuple(state[n_state:]), logw
    return f


@pytest.mark.parametrize("name,carry", [("lg1", False), ("lg1", True), ("lg2", False),
                                        ("lg2", True), ("sv", False), ("sv", True),
                                        ("ucsv", True)])
def test_fused_step_plain_matches_pallas_builder(name, carry):
    """Kernel 2's plain version for each model instance, with and without
    the carried log-weights, against the Pallas builder (interpret mode) fed
    the same normals: planes, log_norm, lse and ess to rtol 1e-5 (f32
    rounding of exp/log in another order). The port runs first: tensors
    allocated while the interpret-mode kernel runs can be written by it."""
    rng = np.random.default_rng(4)
    m, n, y = 16, 512, 0.6
    upd, jupd, p = {"lg1": (LG_UPDATES[1], jax_lg_update(1), 4),
                    "lg2": (LG_UPDATES[2], jax_lg_update(2), 11),
                    "sv": (SV_UPDATE, jax_sv_update, 3),
                    "ucsv": (UCSV_UPDATE, jax_ucsv_update, 2)}[name]
    s = 3 if name == "ucsv" else upd.n_normals
    params = rng.uniform(0.1, 0.9, (m, p)).astype(np.float32)
    state = (0.5 * rng.standard_normal((m, s, n))).astype(np.float32)
    normals = rng.standard_normal((upd.n_normals, m, n)).astype(np.float32)
    a = 3.0 * rng.standard_normal((m, n))
    lw = (a - np.log(np.exp(a).sum(-1, keepdims=True))).astype(np.float32)
    lw[0, :5] = -np.inf  # particles of zero weight stay finite elsewhere
    lw[1] = -50.0 - np.log(n)  # a row carrying very negative log-weights
    carry_t = torch.from_numpy(lw) if carry else None
    ours = [t.numpy().copy() for t in fused_elementwise_step(
        upd, torch.from_numpy(params), torch.from_numpy(state), torch.tensor(y),
        normals=torch.from_numpy(normals), carry_logw=carry_t)]
    planes = tuple(jnp.asarray(state[:, i]) for i in range(s))
    planes += tuple(jnp.asarray(z) for z in normals)
    kw = {"carry_logw": jnp.asarray(lw)} if carry else {}
    with pltpu.force_tpu_interpret_mode():
        new_j, log_norm_j, lse_j, ess_j = jax.block_until_ready(jax_fused_step(
            _jax_injected(jupd, s), 0, y, tuple(jnp.asarray(params[:, i]) for i in range(p)),
            planes, n_normals=upd.n_normals, normalize=True, **kw))
    ref = [np.stack([np.asarray(q) for q in new_j[:s]], 1), np.asarray(log_norm_j),
           np.asarray(lse_j), np.asarray(ess_j)]
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got, want, **TOL)
    assert np.all(np.isfinite(ours[2]))


@pytest.mark.parametrize("kind", ["lg", "uc", "hp"])
def test_kalman_matches_jax(kind):
    """Kalman log Z, final mean and covariance of a θ-cloud (M=5) against
    the JAX filter vmapped over M, full and masked (f32 rounding: rtol 1e-5;
    the log Z sums ~T terms, so atol 1e-4)."""
    ours, ref = _models(kind)
    rng = np.random.default_rng(5)
    y = HP_Y if kind == "hp" else rng.normal(0.0, 1.5, 30).astype(np.float32)
    mask = (np.arange(len(y)) < len(y) - 3).astype(np.float32)
    (mean_t, cov_t), z_t = tsmc.kalman_log_likelihood(ours, torch.from_numpy(y))
    (mean_j, cov_j), z_j = jax.vmap(lambda md: jsmc.kalman_log_likelihood(md, jnp.asarray(y)))(ref)
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **tol)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), **tol)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), **tol)
    _, zm_t = tsmc.kalman_log_likelihood_masked(ours, torch.from_numpy(y), torch.from_numpy(mask))
    _, zm_j = jax.vmap(lambda md: jsmc.kalman_log_likelihood_masked(
        md, jnp.asarray(y), jnp.asarray(mask)))(ref)
    np.testing.assert_allclose(zm_t.numpy(), np.asarray(zm_j), **tol)
    means, _, lls, z = tkal.kalman_filter(ours, torch.from_numpy(y))
    assert means.shape == (len(y), 5, ours.state_dim)
    torch.testing.assert_close(z, z_t, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(lls.sum(0), z_t, rtol=1e-6, atol=1e-5)


def test_simulate_and_interop_model():
    """``simulate`` draws (T, dx) states and (T,) observations; a model
    carried across from the JAX package's arrays keeps them."""
    gen = torch.Generator().manual_seed(0)
    for model, dx in ((tsmc.lg_model(torch.tensor([0.5, 0.9, 0.8])), 1),
                      (tsmc.hodrick_prescott(1600.0, HP_Y, device="cpu"), 2),
                      (tsmc.stochastic_volatility(device="cpu"), 1)):
        x, y = tsmc.simulate(gen, model, 25)
        assert x.shape == (25, dx) and y.shape == (25,)
        assert bool(torch.all(torch.isfinite(y)))
    hp_j = jsmc.hodrick_prescott(1600.0, jnp.asarray(HP_Y))
    hp_t = from_numpy_model(_fields(hp_j), device="cpu")
    for k, v in _fields(hp_j).items():
        np.testing.assert_allclose(getattr(hp_t, k).numpy(), v)
    np.testing.assert_allclose(tsmc.hodrick_prescott(1600.0, HP_Y, device="cpu").x0.numpy(), _fields(hp_j)["x0"],
                               rtol=1e-6)
