"""The port's smoothers (``ops/smoothing.py``) against the JAX package.

Exact, to 1e-5 on the same arrays: the RTS smoother, and each backward
reweighting step, dense and blocked (the −inf block included), fed the JAX
package's own forward clouds through ``interop.from_numpy_cloud``.
Structure: normalized, reproducible smoothed weights equal to the filtered
ones at T, blocked ≡ dense, paths drawn from the forward clouds.
Distributional, at the JAX tests' sizes and tolerances
(``tests/test_smoothing.py``): FFBS marginals and backward-sampled paths
against the exact joint-Gaussian smoother of the filter's own target, and
the posterior-mixture paths. Inputs come from numpy seeds."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import sequential_monte_carlo_tpu as jsmc
from sequential_monte_carlo_tpu.ops import smoothing as jsm
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch import interop
from sequential_monte_carlo_tpu_torch.ops import smoothing as tsm

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

LG_THETA = (0.5, 0.9, 0.8)  # θ* = (A, Q, R)
TOL = dict(rtol=1e-5, atol=1e-5)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def joint_gaussian_smoother(A, Q, B, R, m1, P1, y):
    """Exact smoothed means E[x_t | y_{1:T}] of an LG model with univariate
    observations, x₁ ~ N(m1, P1), by conditioning the joint Gaussian of
    (x_{1:T}, y_{1:T}) on y (independent of any recursion)."""
    T, dx = len(y), A.shape[0]
    means, P = np.zeros((T, dx)), np.zeros((T, dx, dx))
    means[0], P[0] = m1, P1
    for t in range(1, T):
        means[t] = A @ means[t - 1]
        P[t] = A @ P[t - 1] @ A.T + Q
    C = np.zeros((T, T, dx, dx))  # Cov(x_s, x_t)
    for s in range(T):
        C[s, s], acc = P[s], P[s]
        for t in range(s + 1, T):
            acc = acc @ A.T
            C[s, t], C[t, s] = acc, acc.T
    sxy = np.einsum("stij,j->sti", C, B)
    syy = np.einsum("i,stij,j->st", B, C, B) + R * np.eye(T)
    coeff = np.linalg.solve(syy, np.asarray(y, np.float64) - means @ B)
    return means + np.einsum("sti,t->si", sxy, coeff)


@pytest.fixture(scope="module")
def lg():
    """The LG model at θ*, chip_smoke's numpy series (T=40) and the exact
    smoothed means of the particle filter's target (x₁ ~ N(x0, Σ0))."""
    model = tsmc.lg_model(torch.tensor(LG_THETA))
    y = torch.from_numpy(chip_smoke.lg_series(40))
    a, q, r = LG_THETA
    exact = joint_gaussian_smoother(np.array([[a]]), np.array([[q]]), np.array([1.0]), r,
                                    np.zeros(1), np.eye(1), y.numpy())[:, 0]
    return model, y, exact


@pytest.fixture(scope="module")
def ffbs_4096(lg):
    """One FFBS run at the JAX tests' N=4096 (the blocked route)."""
    model, y, _ = lg
    return tsmc.smoothed_marginals(_gen(0), model, 4096, y)


def _hp_like():
    """A dx=2 LG model with a singular Q (Hodrick–Prescott's companion form
    at λ = 100) and a non-singular one."""
    hp = dict(A=[[2.0, -1.0], [1.0, 0.0]], B=[1.0, 0.0], Q=[[0.01, 0.0], [0.0, 0.0]], R=1.0,
              X0=[0.5, 0.4], Sigma0=np.eye(2) * 2.0)
    full = dict(A=[[0.9, 0.1], [0.0, 0.8]], B=[1.0, 0.5], Q=[[0.5, 0.1], [0.1, 0.3]], R=0.8,
                X0=[0.0, 0.0], Sigma0=np.eye(2))
    return {"hp": hp, "full": full}


@pytest.mark.parametrize("name", ["lg1", "hp", "full"])
def test_kalman_smooth_matches_jax(name):
    """RTS means and covariances ≡ the JAX package's on the same model and
    series, to 1e-5; the last step is the filter's."""
    y = chip_smoke.lg_series(50)
    if name == "lg1":
        ours, ref = tsmc.lg_model(torch.tensor(LG_THETA)), jsmc.lg_model(jnp.array(LG_THETA))
    else:
        f = _hp_like()[name]
        ours = tsmc.multivariate_linear_gaussian(**f, device="cpu")
        ref = jsmc.multivariate_linear_gaussian(**{k: jnp.asarray(v, jnp.float32)
                                                   for k, v in f.items()})
    ms, ps = tsmc.kalman_smooth(ours, torch.from_numpy(y))
    jms, jps = jsm.kalman_smooth(ref, jnp.asarray(y))
    torch.testing.assert_close(ms, _t(jms), **TOL)
    torch.testing.assert_close(ps, _t(jps), **TOL)
    mf, pf, _, _ = tsmc.kalman_filter(ours, torch.from_numpy(y))
    assert torch.equal(ms[-1], mf[-1]) and torch.equal(ps[-1], pf[-1])


def _jax_clouds(name: str, n: int):
    """JAX's forward clouds and smoothed weights (``smoothed_marginals`` on
    the dense route) on LG at θ* or UC-SV, with the port's model."""
    if name == "lg":
        jm, tm = jsmc.lg_model(jnp.array(LG_THETA)), tsmc.lg_model(torch.tensor(LG_THETA))
        y = chip_smoke.lg_series(30)
    else:
        theta = np.array([0.3, 3.0, 0.2, 0.3], np.float32)
        jm, tm = jsmc.ucsv_model(jnp.asarray(theta)), tsmc.ucsv_model(torch.from_numpy(theta))
        y = chip_smoke.ucsv_series(20)
    out = jsm.smoothed_marginals(jax.random.key(4), jm, n, jnp.asarray(y), block_size=n)
    return jm, tm, out


@pytest.mark.parametrize("name", ["lg", "ucsv"])
@pytest.mark.parametrize("route", ["dense", "blocked"])
def test_backward_reweight_matches_jax_on_its_clouds(name, route):
    """Each backward step, dense and in blocks of 64, on the JAX package's
    forward clouds (carried across by ``interop.from_numpy_cloud``) and its
    smoothed weights at t + 1, ≡ the JAX package's step to 1e-5; the whole
    backward pass from the port's own steps ≡ JAX's smoothed weights."""
    n = 256
    jm, tm, jout = _jax_clouds(name, n)
    cloud = interop.from_numpy_cloud(jout, device="cpu")
    xs, lw, lws = cloud.particles, cloud.filter_log_weights, cloud.log_weights
    jx, jlw, jlws = jout.particles, jout.filter_log_weights, jout.log_weights
    if route == "dense":
        ours = lambda *a: tsm._backward_reweight_dense(tm, *a)  # noqa: E731
        ref = jax.jit(lambda *a: jsm._backward_reweight_dense(jm, *a))
    else:
        ours = lambda *a: tsm._backward_reweight_blocked(tm, *a, 64)  # noqa: E731
        ref = jax.jit(lambda *a: jsm._backward_reweight_blocked(jm, *a, 64))
    for t in range(xs.shape[0] - 1):
        got = ours(xs[t], lw[t], xs[t + 1], lws[t + 1])
        torch.testing.assert_close(got, _t(ref(jx[t], jlw[t], jx[t + 1], jlws[t + 1])), **TOL)
    whole = tsm.backward_reweight(tm, xs, lw, n if route == "dense" else 64)
    torch.testing.assert_close(whole, lws, **TOL)


@pytest.mark.parametrize("dead", ["first", "middle"])
def test_blocked_neginf_block_matches_dense_and_jax(dead):
    """A row block whose filtered log-weights are all −inf does not
    NaN-poison the blocked route's streaming denominator: it equals the
    dense route and the JAX package's on the same arrays."""
    rng = np.random.default_rng(11)
    n, nb = 32, 8
    x_t, x_next = rng.standard_normal((n, 1)), rng.standard_normal((n, 1))
    a, b = rng.standard_normal(n), rng.standard_normal(n)
    lw_t = (a - np.log(np.exp(a).sum())).astype(np.float32)
    lw_t[slice(0, nb) if dead == "first" else slice(nb, 2 * nb)] = -np.inf
    lw_s_next = (b - np.log(np.exp(b).sum())).astype(np.float32)
    args = [x_t.astype(np.float32), lw_t, x_next.astype(np.float32), lw_s_next]
    tm, jm = tsmc.lg_model(torch.tensor(LG_THETA)), jsmc.lg_model(jnp.array(LG_THETA))
    blocked = tsm._backward_reweight_blocked(tm, *map(_t, args), nb)
    dense = tsm._backward_reweight_dense(tm, *map(_t, args))
    want = jsm._backward_reweight_blocked(jm, *map(jnp.asarray, args), nb)
    live = torch.from_numpy(np.isfinite(lw_t))
    assert torch.isfinite(blocked[live]).all() and torch.all(blocked[~live] == -torch.inf)
    torch.testing.assert_close(blocked, dense, **TOL)
    torch.testing.assert_close(blocked, _t(want), **TOL)


def test_ffbs_weights_normalized_and_reproducible(lg):
    model, y, _ = lg
    out = tsmc.smoothed_marginals(_gen(1), model, 512, y)
    torch.testing.assert_close(torch.exp(out.log_weights).sum(-1), torch.ones(len(y)),
                               rtol=1e-4, atol=1e-4)
    again = tsmc.smoothed_marginals(_gen(1), model, 512, y)
    assert torch.equal(out.log_weights, again.log_weights)
    assert torch.equal(out.log_weights[-1], out.filter_log_weights[-1])
    assert out.particles.shape == (len(y), 512, 1) and out.log_z.shape == ()


@pytest.mark.parametrize("name", ["lg", "ucsv"])
def test_ffbs_blocked_matches_dense(name):
    """The blocked backward pass ≡ the dense one on the same forward clouds
    (the same generator), within the JAX test's 2e-4; a width that does not
    divide N raises."""
    if name == "lg":
        model, y, n = tsmc.lg_model(torch.tensor(LG_THETA)), chip_smoke.lg_series(40), 512
    else:
        model = tsmc.ucsv_model(torch.tensor([0.3, 2.0, -0.5, -0.5]))
        y, n = chip_smoke.ucsv_series(15), 256
    y = torch.from_numpy(y)
    dense = tsmc.smoothed_marginals(_gen(4), model, n, y, block_size=n)
    blocked = tsmc.smoothed_marginals(_gen(4), model, n, y, block_size=n // 4)
    assert torch.equal(dense.particles, blocked.particles)
    torch.testing.assert_close(dense.log_weights, blocked.log_weights, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="block_size"):
        tsmc.smoothed_marginals(_gen(7), model, n, y, block_size=100)


def test_ffbs_matches_joint_gaussian_oracle(lg, ffbs_4096):
    """N=4096 (blocked route): smoothed means within 0.12 of the exact."""
    _, _, exact = lg
    got = tsmc.smoothed_mean(ffbs_4096)[:, 0].numpy()
    assert np.abs(got - exact).max() < 0.12, np.abs(got - exact).max()


def test_ffbs_smoothed_beats_filtered_early(lg, ffbs_4096):
    """Over the first half of the series the smoothed means are closer to
    the exact smoother than the filtered means are."""
    _, y, exact = lg
    xs = ffbs_4096.particles[..., 0]
    filt = (torch.exp(ffbs_4096.filter_log_weights) * xs).sum(-1).numpy()
    smth = (torch.exp(ffbs_4096.log_weights) * xs).sum(-1).numpy()
    early = slice(0, len(y) // 2)
    assert np.abs(smth[early] - exact[early]).mean() < np.abs(filt[early] - exact[early]).mean()


def test_backward_sampling_paths_match_marginals(lg):
    """512 backward-sampled paths over N=2048 clouds: per-t means within
    0.25 of the exact smoother, distinct trajectories, every state one of
    that step's forward particles."""
    model, y, exact = lg
    out = tsmc.smoothed_marginals(_gen(7), model, 2048, y)
    paths = tsmc.sample_smoothed_paths(_gen(8), out, model, 512)
    assert paths.shape == (len(y), 512, 1) and torch.isfinite(paths).all()
    got = paths[:, :, 0].mean(1).numpy()
    assert np.abs(got - exact).max() < 0.25, np.abs(got - exact).max()
    assert torch.unique(paths[0, :, 0]).numel() > 50
    assert torch.isin(paths[5, :, 0], out.particles[5, :, 0]).all()


def test_backward_sampling_paths_ucsv():
    """UC-SV (a TupleProduct transition, 3-dim state): paths are the
    forward clouds' states and track the smoothed marginal means."""
    model = tsmc.ucsv_model(torch.tensor([0.3, 2.0, -0.5, -0.5]))
    y = torch.from_numpy(chip_smoke.ucsv_series(20))
    out = tsmc.smoothed_marginals(_gen(10), model, 256, y)
    paths = tsmc.sample_smoothed_paths(_gen(11), out, model, 64)
    assert paths.shape == (20, 64, 3) and torch.isfinite(paths).all()
    assert torch.isin(paths[0, :, 0], out.particles[0, :, 0]).all()
    m = tsmc.smoothed_mean(out)[:, 0]
    assert (paths[:, :, 0].mean(1) - m).abs().mean() < 1.0


def test_posterior_mixture_smoothing(lg):
    """θ-posterior-mixture paths (n_theta=4 rows of one bank, 64 paths
    each, N=1024): a point-mass θ-cloud at θ* gives the exact smoother
    within 0.3; a dispersed cloud spreads the paths at least 0.8× as much."""
    model, y, exact = lg
    theta = torch.tensor(LG_THETA).expand(16, 3).contiguous()
    paths = tsmc.posterior_smoothed_paths(_gen(0), tsmc.lg_model, theta, torch.zeros(16), y,
                                          n=1024, n_theta=4, n_paths=64)
    assert paths.shape == (len(y), 256, 1)
    got = paths[:, :, 0].mean(1).numpy()
    assert np.abs(got - exact).max() < 0.3, np.abs(got - exact).max()
    rng = np.random.default_rng(1)
    disp = torch.from_numpy(np.abs(np.array(LG_THETA) + 0.2 * rng.standard_normal((16, 3)))
                            .astype(np.float32))
    paths_d = tsmc.posterior_smoothed_paths(_gen(2), tsmc.lg_model, disp, torch.zeros(16), y,
                                            n=1024, n_theta=4, n_paths=64)
    assert paths_d[:, :, 0].var(1).mean() > 0.8 * paths[:, :, 0].var(1).mean()


def test_posterior_mixture_rows_are_the_per_theta_smoothers():
    """Each of the bank's θ-rows draws from its own θ's smoother: with two
    θ far apart (ω equal), the pooled paths split into two groups whose
    means follow each θ's exact smoother."""
    y = torch.from_numpy(chip_smoke.lg_series(30))
    theta = torch.tensor([[0.5, 0.9, 0.8], [0.5, 0.05, 3.0]])
    paths = tsmc.posterior_smoothed_paths(_gen(5), tsmc.lg_model, theta, torch.zeros(2), y,
                                          n=1024, n_theta=8, n_paths=64)
    # a row's 64 paths come from one θ; which θ shows in their spread
    rows = paths[:, :, 0].T.reshape(8, 64, -1)
    for row in rows:
        mean = row.mean(0).numpy()
        exacts = []
        for a, q, r in theta.tolist():
            exacts.append(joint_gaussian_smoother(np.array([[a]]), np.array([[q]]),
                                                  np.array([1.0]), r, np.zeros(1), np.eye(1),
                                                  y.numpy())[:, 0])
        assert min(np.abs(mean - e).max() for e in exacts) < 0.4
