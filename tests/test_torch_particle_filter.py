"""The port's per-θ particle filters (``ops/particle_filter.py``, the batched
filter at one row) and its posterior summaries (``analysis/summaries.py``)
against the JAX package.

Structure: ``pf_step``/``apf_step`` at one θ are bitwise the batched step on
the lifted one-row model from the same generator, and the masked
log-likelihood of a prefix is bitwise the prefix's. Distributional, at the
JAX tests' sizes and tolerances (``tests/test_particle_filter.py``): per-θ,
every scheme's, the guided and the auxiliary filter's log Z against the
Kalman log Z of the filter's own target, and UC-SV filters against the JAX
package's in distribution. Exact: the summaries against the JAX package's on
the same arrays, and the SMC² and IBIS summaries from a JAX state carried
across, to 1e-5. Inputs come from numpy seeds."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import sequential_monte_carlo_tpu as jsmc
from sequential_monte_carlo_tpu.analysis import summaries as jsum
from sequential_monte_carlo_tpu.samplers.base import IBISState as JIBISState
from sequential_monte_carlo_tpu.samplers.base import SMC2State as JSMC2State
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch import interop
from sequential_monte_carlo_tpu_torch.analysis import summaries as tsum

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

LG_THETA = (0.5, 0.9, 0.8)  # θ* = (A, Q, R)
TOL = dict(rtol=1e-5, atol=1e-5)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def lg_data():
    """The LG model at θ* and chip_smoke's numpy series (T=100); the Kalman
    log Z of the filter's own target (the filter draws x₁ ~ N(x0, Σ0), the
    Kalman filter predicts x₁ from (x0', Σ0') with Σ0' = (Σ0 − Q)/A²)."""
    a, q, r = LG_THETA
    model = tsmc.lg_model(torch.tensor(LG_THETA))
    y = torch.from_numpy(chip_smoke.lg_series(100))
    target = tsmc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2,
                                             device="cpu")
    return model, y, tsmc.kalman_log_likelihood(target, y)[1].item()


def _models():
    return {
        "lg": tsmc.lg_model(torch.tensor(LG_THETA)),
        "sv": tsmc.stochastic_volatility(device="cpu"),
        "ucsv": tsmc.ucsv_model(torch.tensor([0.2, 3.0, 0.3, 0.3])),
        "lg2": tsmc.multivariate_linear_gaussian(A=[[0.9, 0.1], [0.0, 0.8]], B=[1.0, 0.5],
                                                 Q=[[0.5, 0.1], [0.1, 0.3]], R=0.8,
                                                 device="cpu"),
    }


@pytest.mark.parametrize("name", ["lg", "sv", "ucsv", "lg2"])
def test_broadcast_model_lifts_every_family(name):
    """broadcast_model gives every field a leading θ axis of the asked
    length, and the lifted bank's kernel parameters and densities are the
    model's, row by row."""
    model = _models()[name]
    bank = tsmc.broadcast_model(model, 3)
    for f in ("x0", "A", "mu", "gamma_eps"):
        if hasattr(model, f):
            assert getattr(bank, f).shape == (3,) + tuple(getattr(model, f).shape)
    params = bank.fused_params()
    assert params.shape[0] == 3 and torch.equal(params[0], params[2])
    dx = bank.initial_distribution().sample(_gen(0), (5,)).shape[-1]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, dx)).astype(np.float32))
    torch.testing.assert_close(bank.observation_distribution(x[:, None, :].expand(5, 3, dx)).log_prob(0.3)[:, 1],
                               model.observation_distribution(x).log_prob(0.3), **TOL)


CONFIGS = {"systematic": tsmc.PFConfig(), "stratified_ess": tsmc.PFConfig("stratified", 0.5),
           "multinomial": tsmc.PFConfig("multinomial")}


@pytest.mark.parametrize("name", ["lg", "sv", "ucsv"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_pf_step_is_the_batched_step_at_one_row(name, cfg):
    """pf_step at one θ ≡ batched_pf_step on the one-row bank, bit for bit,
    from the same generator state; so is apf_step with the auxiliary
    config."""
    model = _models()[name]
    bank = tsmc.broadcast_model(model)
    init = tsmc.pf_init(_gen(1), model, 256, torch.tensor(3.1))
    ref = tsmc.batched_pf_init(_gen(1), bank, 256, 1, torch.tensor(3.1))
    assert torch.equal(init.state.particles, ref.particles[0])
    assert torch.equal(init.state.log_weights, ref.log_weights[0])
    assert init.state.particles.shape == (256, bank.initial_distribution().sample(
        _gen(0)).shape[-1]) and init.state.log_weights.shape == (256,)
    for step, config in ((tsmc.pf_step, CONFIGS[cfg]),
                         (tsmc.apf_step, tsmc.PFConfig(CONFIGS[cfg].resampling,
                                                       algorithm="apf"))):
        out = step(_gen(2), model, init.state, torch.tensor(2.7), config)
        want = tsmc.batched_pf_step(_gen(2), bank, ref.particles, ref.log_weights,
                                    torch.tensor(2.7), config)
        assert torch.equal(out.state.particles, want.particles[0])
        assert torch.equal(out.state.log_weights, want.log_weights[0])
        assert torch.equal(out.log_mean, want.log_mean[0]) and torch.equal(out.ess, want.ess[0])
        assert out.log_mean.shape == () and out.ess.shape == ()


@pytest.mark.parametrize("normalize", [True, False])
def test_propagate_wrapper_takes_any_stride_on_length_one_axes(normalize):
    """A one-row, one-plane cloud (the per-θ LG filter's) is dense whatever
    the strides of its length-1 axes; the resample kernel's output keeps
    such strides, so K2's wrapper must take them: the same result as on the
    contiguous cloud."""
    from sequential_monte_carlo_tpu_torch.kernels.propagate import fused_elementwise_step

    bank = tsmc.broadcast_model(tsmc.lg_model(torch.tensor(LG_THETA)))
    rng = np.random.default_rng(6)
    state = torch.from_numpy(rng.standard_normal((1, 1, 64)).astype(np.float32))
    odd = state.new_empty_strided((1, 1, 64), (1, 1, 1))
    odd.copy_(state)
    z = torch.from_numpy(rng.standard_normal((1, 1, 64)).astype(np.float32))
    y, params = torch.tensor(0.4), bank.fused_params()
    got = fused_elementwise_step(bank.update, params, odd, y, normals=z, normalize=normalize)
    want = fused_elementwise_step(bank.update, params, state, y, normals=z, normalize=normalize)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_masked_log_likelihood_is_the_prefix(lg_data):
    """The masked log-likelihood steps only where mask > 0, so a prefix mask
    gives the prefix's run, bitwise, from the same generator."""
    model, y, _ = lg_data
    mask = (torch.arange(y.shape[0]) < 37).float()
    st_m, z_m = tsmc.log_likelihood_masked(_gen(3), model, 256, y, mask)
    st_p, z_p = tsmc.log_likelihood(_gen(3), model, 256, y[:37])
    assert torch.equal(z_m, z_p) and torch.equal(st_m.particles, st_p.particles)
    _, z_again = tsmc.log_likelihood(_gen(3), model, 256, y[:37])
    assert torch.equal(z_again, z_p)


def test_filter_sequence_telemetry(lg_data):
    """filter_sequence's series: log_mean and ess (T,), the summary of the
    (N, dx) ParticleState stacked over T (a weighted_quantile), log Z their
    sum; the final state is the last step's."""
    model, y, _ = lg_data
    seen = []

    def summarize(state):
        seen.append(tuple(state.particles.shape))
        return tsum.weighted_quantile(state.particles[:, 0], torch.exp(state.log_weights),
                                      [0.1, 0.5, 0.9])

    state, logz, series = tsmc.filter_sequence(_gen(9), model, 256, y, summarize=summarize)
    T = y.shape[0]
    assert series["log_mean"].shape == (T,) and series["ess"].shape == (T,)
    assert series["summary"].shape == (T, 3)
    assert torch.all(series["summary"][:, 0] <= series["summary"][:, 2])
    assert set(seen) == {(256, 1)}
    assert float(logz) == pytest.approx(float(series["log_mean"].sum()), rel=1e-6)
    # the same draws as log_likelihood's; log Z summed in another order
    state_ll, logz_ll = tsmc.log_likelihood(_gen(9), model, 256, y)
    assert torch.equal(state.particles, state_ll.particles)
    assert float(logz) == pytest.approx(float(logz_ll), rel=1e-6)
    assert state.particles.shape == (256, 1)


def test_unknown_scheme_raises(lg_data):
    model, y, _ = lg_data
    with pytest.raises(ValueError, match="resampling scheme"):
        tsmc.log_likelihood(_gen(0), model, 64, y, tsmc.PFConfig("nope"))


def _log_zs(fn, reps: int, seed: int) -> np.ndarray:
    return np.array([float(fn(_gen(seed * 1000 + r))[1]) for r in range(reps)])


def test_pf_logz_within_mc_error_of_kalman(lg_data):
    """BASELINE config 1 (the JAX test's): multinomial at every step, N=1024,
    20 repeats; within max(4 se, 0.5) of the exact log Z."""
    model, y, kz = lg_data
    zs = _log_zs(lambda g: tsmc.log_likelihood(g, model, 1024, y,
                                               tsmc.PFConfig("multinomial", 1.0)), 20, 1)
    se = zs.std(ddof=1) / math.sqrt(20)
    assert abs(zs.mean() - kz) < max(4 * se, 0.5)
    assert zs.std(ddof=1) < 2.0


@pytest.mark.parametrize("scheme", ["systematic", "stratified", "multinomial"])
def test_pf_logz_all_schemes(lg_data, scheme):
    """Each scheme with ESS-triggered resampling (τ = 0.5), N=512, 10
    repeats: within max(5 se, 1.0) of the exact log Z."""
    model, y, kz = lg_data
    zs = _log_zs(lambda g: tsmc.log_likelihood(g, model, 512, y, tsmc.PFConfig(scheme, 0.5)),
                 10, 2)
    se = zs.std(ddof=1) / math.sqrt(10)
    assert abs(zs.mean() - kz) < max(5 * se, 1.0)


def test_apf_logz_within_mc_error_of_kalman(lg_data):
    """The auxiliary filter, N=1024, 12 repeats: within max(5 se, 1.0) of
    the exact log Z, sd below 2."""
    model, y, kz = lg_data
    zs = _log_zs(lambda g: tsmc.apf_log_likelihood(g, model, 1024, y), 12, 21)
    se = zs.std(ddof=1) / math.sqrt(12)
    assert abs(zs.mean() - kz) < max(5 * se, 1.0)
    assert zs.std(ddof=1) < 2.0


def test_guided_filter_with_the_transition_as_proposal(lg_data):
    """A guided filter whose proposal is the transition estimates the same
    log Z: 8 repeats at N=512 within 1.5 of the exact."""
    model, y, kz = lg_data
    prop = tsmc.Proposal(initial=lambda mm: mm.initial_distribution(),
                         step=lambda mm, xp: mm.transition_distribution(xp))
    zs = _log_zs(lambda g: tsmc.log_likelihood(g, model, 512, y, tsmc.PFConfig(), prop), 8, 5)
    assert abs(zs.mean() - kz) < 1.5


@pytest.mark.parametrize("algorithm", ["bootstrap", "apf"])
def test_ucsv_log_likelihood_matches_jax_in_distribution(algorithm):
    """Per-θ UC-SV filters (N=256, T=60 of chip_smoke's series) at one θ:
    24 runs of the port against 24 of the JAX package's per-θ filter, means
    within 5 combined standard errors."""
    theta = np.array([0.2, 3.0, 0.3, 0.3], np.float32)
    y = chip_smoke.ucsv_series(60)
    model = tsmc.ucsv_model(torch.from_numpy(theta))
    fn = tsmc.log_likelihood if algorithm == "bootstrap" else tsmc.apf_log_likelihood
    ours = _log_zs(lambda g: fn(g, model, 256, torch.from_numpy(y)), 24, 7)
    jfn = jsmc.log_likelihood if algorithm == "bootstrap" else jsmc.apf_log_likelihood
    jmodel = jsmc.ucsv_model(jnp.asarray(theta))
    ref = np.asarray(jax.vmap(lambda k: jfn(k, jmodel, 256, jnp.asarray(y))[1])(
        jax.random.split(jax.random.key(7), 24)))
    se = math.sqrt(ours.var(ddof=1) / 24 + ref.var(ddof=1) / 24)
    assert np.isfinite(ours).all() and abs(ours.mean() - ref.mean()) < 5 * se


def test_sv_filter_runs():
    """BASELINE config 2: the SV model, ESS-triggered systematic, N=4096."""
    model = tsmc.stochastic_volatility(device="cpu")
    y = torch.from_numpy(chip_smoke.sv_series(-1.0, 0.95, 0.3, 80))
    _, z = tsmc.log_likelihood(_gen(1), model, 4096, y, tsmc.PFConfig("systematic", 0.5))
    assert math.isfinite(float(z))


# -- summaries ---------------------------------------------------------------

PS = [0.05, 0.25, 0.5, 0.75, 0.95]


def _cloud(m: int, n: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.5, (m, n)).astype(np.float32)
    a = 2.0 * rng.standard_normal((m, n))
    w = np.exp(a - a.max(-1, keepdims=True))
    return x, (w / w.sum(-1, keepdims=True)).astype(np.float32)


def test_weighted_quantile_matches_jax():
    """weighted_quantile on one row ≡ the JAX package's; on (M, N) rows ≡
    JAX's mapped over them (the port batches it)."""
    x, w = _cloud(6, 1000)
    got = tsum.weighted_quantile(torch.from_numpy(x[0]), torch.from_numpy(w[0]), PS)
    want = jsum.weighted_quantile(jnp.asarray(x[0]), jnp.asarray(w[0]), jnp.asarray(PS))
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)
    got = tsum.weighted_quantile(torch.from_numpy(x), torch.from_numpy(w), PS)
    want = jax.vmap(lambda a, b: jsum.weighted_quantile(a, b, jnp.asarray(PS)))(
        jnp.asarray(x), jnp.asarray(w))
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


@pytest.mark.parametrize("bins", [16, 128])
def test_weighted_quantile_binned_mean_var_match_jax(bins):
    x, w = _cloud(6, 1000, seed=5)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    torch.testing.assert_close(
        tsum.weighted_quantile_binned(tx, tw, PS, bins=bins),
        torch.from_numpy(np.array(jsum.weighted_quantile_binned(jx, jw, PS, bins=bins))), **TOL)
    torch.testing.assert_close(tsum.weighted_mean(tx, tw),
                               torch.from_numpy(np.array(jsum.weighted_mean(jx, jw))), **TOL)
    torch.testing.assert_close(tsum.weighted_var(tx, tw),
                               torch.from_numpy(np.array(jsum.weighted_var(jx, jw))), **TOL)


def _ucsv_state(m: int = 16, n: int = 300):
    """A JAX SMC2State on UC-SV made from numpy arrays, and the port's of
    the same arrays (``interop.from_numpy_state``)."""
    rng = np.random.default_rng(8)
    theta = np.stack([rng.uniform(0.05, 0.4, m), rng.normal(3.0, 0.5, m),
                      rng.uniform(0.0, 1.0, m), rng.uniform(0.0, 1.0, m)], 1).astype(np.float32)
    particles = np.stack([rng.normal(3.0, 0.7, (m, n)), rng.normal(-0.5, 0.4, (m, n)),
                          rng.normal(-0.3, 0.4, (m, n))], -1).astype(np.float32)
    a = rng.standard_normal((m, n))
    log_w = (a - np.log(np.exp(a).sum(-1, keepdims=True))).astype(np.float32)
    fields = dict(theta=theta, log_omega=rng.normal(0.0, 1.0, m).astype(np.float32),
                  particles=particles, log_w=log_w, log_z=np.zeros(m, np.float32),
                  ess=np.float32(m), acc_ratio=np.float32(0.3), t=10)
    jstate = JSMC2State(key=jax.random.key(0), active_n=None,
                        **{k: jnp.asarray(v) for k, v in fields.items()})
    return jstate, interop.from_numpy_state(fields, device="cpu")


@pytest.mark.parametrize("method", ["binned", "sort"])
def test_smc2_summaries_match_jax(method):
    """state_quantiles, cycle_quantiles (both methods), state_variance,
    estimated_trend and predictive_quantiles of a JAX SMC² state carried
    across ≡ the JAX package's."""
    jstate, state = _ucsv_state()
    got = {"state": tsum.state_quantiles(state, PS, 0, method),
           "cycle": tsum.cycle_quantiles(state, torch.tensor(3.2), PS, 0, method),
           "var": tsum.state_variance(state, 1),
           "trend": tsum.estimated_trend(state, tsmc.ucsv_model),
           "pred": tsum.predictive_quantiles(state, tsmc.ucsv_model, PS[::-1])}
    jmodel = jsmc.ucsv_model
    want = {"state": jsum.state_quantiles(jstate, jnp.asarray(PS), 0, method),
            "cycle": jsum.cycle_quantiles(jstate, 3.2, jnp.asarray(PS), 0, method),
            "var": jsum.state_variance(jstate, 1),
            "trend": jsum.estimated_trend(jstate, jmodel),
            "pred": jsum.predictive_quantiles(jstate, jmodel, jnp.asarray(PS[::-1]))}
    for k in got:
        torch.testing.assert_close(got[k], torch.from_numpy(np.array(want[k])), **TOL)


def test_ibis_summaries_match_jax():
    """observation_dist, ibis_estimated_trend and ibis_predictive_quantiles
    of a JAX IBIS state (LG Kalman bank) carried across ≡ the JAX
    package's."""
    rng = np.random.default_rng(9)
    m = 16
    theta = np.stack([rng.uniform(-0.9, 0.9, m), rng.uniform(0.2, 2.0, m),
                      rng.uniform(0.2, 2.0, m)], 1).astype(np.float32)
    fields = dict(theta=theta, log_omega=rng.normal(0.0, 1.0, m).astype(np.float32),
                  mean=rng.normal(0.0, 1.0, (m, 1)).astype(np.float32),
                  cov=rng.uniform(0.1, 1.0, (m, 1, 1)).astype(np.float32),
                  log_z=np.zeros(m, np.float32), ess=np.float32(m),
                  acc_ratio=np.float32(0.3), t=5)
    jstate = JIBISState(key=jax.random.key(0), **{k: jnp.asarray(v) for k, v in fields.items()})
    state = interop.from_numpy_ibis_state(fields, device="cpu")
    for got, want in ((tsum.observation_dist(state, tsmc.lg_model),
                       jsum.observation_dist(jstate, jsmc.lg_model)),
                      ((tsum.ibis_estimated_trend(state, tsmc.lg_model),),
                       (jsum.ibis_estimated_trend(jstate, jsmc.lg_model),)),
                      ((tsum.ibis_predictive_quantiles(state, tsmc.lg_model, PS),),
                       (jsum.ibis_predictive_quantiles(jstate, jsmc.lg_model, jnp.asarray(PS)),))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, torch.from_numpy(np.array(b)), **TOL)


def test_posterior_histograms_draw_from_the_generator():
    """posterior_histograms: one (counts, edges) pair per θ dimension,
    n_samples draws each, reproducible from the generator."""
    _, state = _ucsv_state()
    a = tsum.posterior_histograms(_gen(3), state, n_samples=2000, bins=20)
    b = tsum.posterior_histograms(_gen(3), state, n_samples=2000, bins=20)
    assert len(a) == 4 and all(c.sum() == 2000 and e.shape == (21,) for c, e in a)
    assert all(np.array_equal(c1, c2) for (c1, _), (c2, _) in zip(a, b))
