"""The port's conditional SMC (``ops/csmc.py``) and particle Gibbs
(``samplers/particle_gibbs.py``) against the JAX package.

Exact, to 1e-5 on the same arrays: the complete-data log-density on LG, SV
and UC-SV. Structure: CSMC pins slot 0 to the reference path (carried across
from the JAX package by ``interop.from_numpy_path``), its ancestors are
(T − 1, N) int32 with slot 0's fixed at 0 without ancestor sampling; the
method, ``chain`` and ``sweeps`` errors; a scalar θ; ``rw_sigma`` from the
caller's generator. Distributional, at the JAX tests' sizes and tolerances
(``tests/test_particle_gibbs.py``): iterated CSMC, "bs" and "as", against
the RTS smoother of the filter's own target, and the particle-Gibbs θ-chain
against the Kalman prior-IS posterior. Inputs come from numpy seeds."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import sequential_monte_carlo_tpu as jsmc
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch import interop
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.samplers.particle_gibbs import _particle_gibbs_bank

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

LG_THETA = (0.5, 0.9, 0.8)  # θ* = (A, Q, R)
LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def lg_setup():
    """LG at θ*, chip_smoke's numpy series (T=40), and the RTS smoother of
    the particle filter's target (x₁ ~ N(0, 1): the Kalman filter's from
    Σ0' = (Σ0 − Q)/A²): means and sds."""
    a, q, r = LG_THETA
    model = tsmc.lg_model(torch.tensor(LG_THETA))
    y = torch.from_numpy(chip_smoke.lg_series(40))
    target = tsmc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2,
                                             device="cpu")
    ms, ps = tsmc.kalman_smooth(target, y)
    return model, y, ms[:, 0].numpy(), torch.sqrt(ps[:, 0, 0]).numpy()


@pytest.mark.parametrize("name", ["lg", "sv", "ucsv"])
def test_complete_data_log_prob_matches_jax(name):
    """log p(x_{1:T}, y_{1:T} | θ) ≡ the JAX package's on the same θ, path
    and series, to 1e-5."""
    rng = np.random.default_rng(2)
    T = 30
    if name == "lg":
        theta = np.array(LG_THETA, np.float32)
        ours, ref = tsmc.lg_model(torch.from_numpy(theta)), jsmc.lg_model(jnp.asarray(theta))
        x = rng.standard_normal((T, 1))
    elif name == "sv":
        theta = np.array([-1.0, 0.95, 0.3], np.float32)
        ours, ref = tsmc.sv_model(torch.from_numpy(theta)), jsmc.sv_model(jnp.asarray(theta))
        x = rng.normal(-1.0, 0.5, (T, 1))
    else:
        theta = np.array([0.2, 3.0, 0.3, 0.3], np.float32)
        ours, ref = tsmc.ucsv_model(torch.from_numpy(theta)), jsmc.ucsv_model(jnp.asarray(theta))
        x = np.stack([rng.normal(3.0, 0.5, T), rng.normal(-0.5, 0.3, T),
                      rng.normal(-0.3, 0.3, T)], 1)
    x, y = x.astype(np.float32), rng.normal(0.0, 1.0, T).astype(np.float32)
    got = tsmc.complete_data_log_prob(ours, torch.from_numpy(x), torch.from_numpy(y))
    want = jsmc.complete_data_log_prob(ref, jnp.asarray(x), jnp.asarray(y))
    torch.testing.assert_close(got, torch.tensor(float(want)), **TOL)


@pytest.mark.parametrize("name", ["lg", "ucsv"])
def test_csmc_pins_the_reference_slot(name):
    """Slot 0 of every forward cloud is the reference path (a JAX draw
    carried across); the ancestors are (T − 1, N) int32, slot 0's all 0
    without ancestor sampling and redrawn with it; the filtered weights are
    normalized and slot 0's log-weight is g(y_t | ref_t) less the step's
    normalizer."""
    if name == "lg":
        jm, model = jsmc.lg_model(jnp.array(LG_THETA)), tsmc.lg_model(torch.tensor(LG_THETA))
        y = torch.from_numpy(chip_smoke.lg_series(40))
    else:
        theta = np.array([0.2, 3.0, 0.3, 0.3], np.float32)
        jm, model = jsmc.ucsv_model(jnp.asarray(theta)), tsmc.ucsv_model(torch.from_numpy(theta))
        y = torch.from_numpy(chip_smoke.ucsv_series(40))
    ref = interop.from_numpy_path(np.asarray(jsmc.simulate(jax.random.key(3), jm, 40)[0]),
                                  device="cpu")
    for pgas in (False, True):
        cloud, anc = tsmc.csmc_forward(_gen(0), model, 64, y, ref, ancestor_sampling=pgas)
        assert torch.equal(cloud.particles[:, 0, :], ref)
        assert anc.shape == (39, 64) and anc.dtype == torch.int32
        assert bool(torch.all(anc[:, 0] == 0)) != pgas
        torch.testing.assert_close(torch.logsumexp(cloud.filter_log_weights, -1),
                                   torch.zeros(40), **TOL)
        g0 = model.observation_distribution(ref).log_prob(y)  # (T,)
        lse = torch.logsumexp(cloud.filter_log_weights[:, 1:] - cloud.filter_log_weights[:, :1], -1)
        # w_0 / Σ_{j≥1} w_j from the cloud ≡ g_0 / Σ_{j≥1} g_j of slot 0's density
        gj = model.observation_distribution(cloud.particles[:, 1:, :]).log_prob(y[:, None])
        torch.testing.assert_close(-lse, g0 - torch.logsumexp(gj, -1), rtol=1e-4, atol=1e-4)


def test_csmc_reproducible_and_validates_method(lg_setup):
    model, y, _, _ = lg_setup
    ref = torch.zeros((40, 1))
    a = tsmc.csmc_sweep(_gen(5), model, 64, y, ref)
    b = tsmc.csmc_sweep(_gen(5), model, 64, y, ref)
    assert torch.equal(a.path, b.path) and a.path.shape == (40, 1)
    with pytest.raises(ValueError, match="method"):
        tsmc.csmc_sweep(_gen(0), model, 64, y, ref, method="nope")


def test_pgas_path_is_an_ancestral_lineage(lg_setup):
    """With ancestor sampling the new path is the lineage of its endpoint
    through the forward pass's ancestors: x_t = particles[t, b_t] with
    b_t = ancestors[t][b_{t+1}]."""
    model, y, _, _ = lg_setup
    out = tsmc.csmc_sweep(_gen(9), model, 64, y, torch.zeros((40, 1)), method="as")
    xs, anc = out.cloud.particles, out.ancestors.long()
    b = int(torch.nonzero(xs[-1, :, 0] == out.path[-1, 0])[0])
    for t in range(38, -1, -1):
        b = int(anc[t, b])
        assert torch.equal(out.path[t], xs[t, b])


@pytest.mark.parametrize("method", ["bs", "as"])
def test_csmc_invariance_matches_rts(lg_setup, method):
    """Iterated CSMC at fixed θ samples p(x_{1:T} | y, θ): over 120 sweeps
    from a bad start (N=256), the pooled path means of the last 80 within
    0.75 sd of RTS at every t and 0.3 sd on average."""
    model, y, ms, sd = lg_setup
    gen, path, paths = _gen(7), torch.zeros((40, 1)), []
    for _ in range(120):
        path = tsmc.csmc_sweep(gen, model, 256, y, path, method=method).path
        paths.append(path[:, 0])
    pooled = torch.stack(paths[40:]).mean(0).numpy()
    err = np.abs(pooled - ms) / sd
    assert err.max() < 0.75, (err.max(), err.mean())
    assert err.mean() < 0.3, err.mean()


@pytest.fixture(scope="module")
def pg_setup():
    """The JAX test's PG problem on chip_smoke's numpy LG series (T=60), its
    prior, and the prior-IS posterior mean (100,000 draws, Kalman log Z)."""
    prior = prior_from_spec(LG_PRIOR, device="cpu")
    y = torch.from_numpy(chip_smoke.lg_series(60))
    theta = prior.sample(_gen(77), (100_000,))
    _, lz = tsmc.kalman_log_likelihood(tsmc.lg_model(theta), y)
    return prior, y, (torch.softmax(lz.double(), 0) @ theta.double()).numpy()


def test_particle_gibbs_posterior_matches_oracle(pg_setup):
    """The JAX test's chain (N=128, 400 sweeps, chain=3), 8 of them as the
    rows of one bank (``_particle_gibbs_bank``): each acceptance adapted into
    (0.1, 0.6), and the θ-chain means after 150 sweeps, pooled over the
    chains, within the JAX test's 0.3 of the oracle. One chain's mean
    spreads too widely for 0.3 (in the JAX package's PG too:
    ``tools/jax_reference.py --run pg_lg``), so the chains are pooled."""
    prior, y, oracle = pg_setup
    gen = _gen(11)
    res = _particle_gibbs_bank(gen, tsmc.lg_model, prior, y,
                               tsmc.PGConfig(n_particles=128, sweeps=400, chain=3),
                               prior.sample(gen, (8,)))
    assert res.theta.shape == (400, 8, 3) and res.final_path.shape == (60, 8, 1)
    assert res.acc_ratio.shape == (8,)
    assert torch.all((0.1 < res.acc_ratio) & (res.acc_ratio < 0.6)), res.acc_ratio
    means = res.theta[150:].mean(0).numpy()
    got = means.mean(0)
    assert np.all(np.abs(got - oracle) < 0.3), (means, oracle)
    # the chains are independent: they start apart and stay apart
    assert len({tuple(r) for r in res.theta[0].tolist()}) == 8


def test_particle_gibbs_on_nonlinear_ucsv():
    """PG with PGAS on UC-SV (N=64, 40 sweeps, chain=2): finite, in the
    prior's support."""
    y = torch.from_numpy(chip_smoke.ucsv_series(50))
    prior = prior_from_spec(chip_smoke.PRIOR_SPEC, device="cpu")
    res = tsmc.particle_gibbs(_gen(4), tsmc.ucsv_model, prior, y,
                              tsmc.PGConfig(n_particles=64, sweeps=40, chain=2, method="as"))
    assert res.theta.shape == (40, 4) and torch.isfinite(res.theta).all()
    assert torch.isfinite(res.final_path).all() and res.final_path.shape == (50, 3)
    assert bool(prior.in_support(res.theta[-1]))


@pytest.mark.parametrize("field, value, match", [("chain", 0, "chain"), ("sweeps", 0, "sweeps"),
                                                 ("method", "nope", "method")])
def test_particle_gibbs_rejects_bad_configs(pg_setup, field, value, match):
    """chain < 1 and sweeps < 1 (where the JAX package returns a NaN
    acceptance) and an unknown method raise before any work."""
    prior, y, _ = pg_setup
    cfg = tsmc.PGConfig(n_particles=16, sweeps=2)._replace(**{field: value})
    with pytest.raises(ValueError, match=match):
        tsmc.particle_gibbs(_gen(0), tsmc.lg_model, prior, y, cfg)


def test_particle_gibbs_takes_a_scalar_theta():
    """A scalar prior (the SV model's mean level): the chain is (sweeps, 1),
    and the prior and model_fn see the prior's own scalar shape (the JAX
    package raises IndexError here)."""
    prior = tsmc.Normal(torch.tensor(-1.0), torch.tensor(0.5))
    y = torch.from_numpy(chip_smoke.sv_series(-1.0, 0.95, 0.3, 40))
    shapes = []

    def model_fn(mu):
        shapes.append(tuple(mu.shape))
        return tsmc.StochasticVolatilityModel(mu=mu, phi=torch.tensor(0.95), sigma=torch.tensor(0.3))

    res = tsmc.particle_gibbs(_gen(1), model_fn, prior, y,
                              tsmc.PGConfig(n_particles=32, sweeps=6, chain=2))
    assert res.theta.shape == (6, 1) and torch.isfinite(res.theta).all()
    assert set(shapes) == {()}


def test_particle_gibbs_draws_rw_sigma_from_the_generator(pg_setup):
    """The default rw_sigma is rw_scale × the std of 1024 prior draws made
    from the caller's generator right after θ0 (not from a fixed key): the
    same draws made by hand and passed in give the same chain, bit for bit;
    collect_paths returns every sweep's path, the last the final path."""
    prior, y, _ = pg_setup
    cfg = tsmc.PGConfig(n_particles=64, sweeps=8, collect_paths=True)
    a = tsmc.particle_gibbs(_gen(2), tsmc.lg_model, prior, y, cfg)
    gen = _gen(2)
    theta0 = prior.sample(gen)
    rw = cfg.rw_scale * torch.std(prior.sample(gen, (1024,)), dim=0, correction=0)
    b = tsmc.particle_gibbs(gen, tsmc.lg_model, prior, y, cfg, theta0=theta0, rw_sigma=rw)
    assert torch.equal(a.theta, b.theta)
    c = tsmc.particle_gibbs(_gen(3), tsmc.lg_model, prior, y, cfg)
    assert not torch.equal(a.theta, c.theta)
    assert a.paths.shape == (8, 60, 1) and torch.equal(a.paths[-1], a.final_path)


@pytest.mark.parametrize("method", ["bs", "as"])
def test_particle_gibbs_is_the_bank_at_one_row(pg_setup, method):
    """The public chain is ``_particle_gibbs_bank``'s one-row case: from the
    same generator, θ0 drawn first, the same chain, acceptance and paths bit
    for bit, without the chain axis."""
    prior, y, _ = pg_setup
    cfg = tsmc.PGConfig(n_particles=32, sweeps=5, chain=2, method=method, collect_paths=True)
    a = tsmc.particle_gibbs(_gen(5), tsmc.lg_model, prior, y, cfg)
    gen = _gen(5)
    b = _particle_gibbs_bank(gen, tsmc.lg_model, prior, y, cfg, prior.sample(gen)[None])
    assert a.theta.shape == (5, 3) and b.theta.shape == (5, 1, 3) and a.acc_ratio.shape == ()
    assert torch.equal(a.theta, b.theta[:, 0]) and torch.equal(a.acc_ratio, b.acc_ratio[0])
    assert torch.equal(a.final_path, b.final_path[:, 0])
    assert torch.equal(a.paths, b.paths[:, :, 0])
