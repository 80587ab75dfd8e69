"""The port's model DSL (``models/dsl.py``) and the propagate route of a
model without a fused kernel, against the JAX package.

One test per JAX DSL test (``tests/test_dsl.py``): introspection, free
parameter inference, an observe-only parameter, the wrong-θ error, simulate
and filter, a default override, a single-state model, SMC². Exact, on the
same numpy states: the same program written with ``jnp`` and with ``torch``
gives the same three densities to 1e-6 relative, and the DSL UC-SV's densities
are the native ``UCSVModel``'s; ``linear_ssm_model``'s Kalman log Z is the JAX
package's for the same declaration to 1e-5 relative. Distributional: a DSL
AR(1)'s log Z against the Kalman filter's on every inner route (every
scheme, ESS-triggered, the elastic live count, the APF), the DSL UC-SV's log Z
against the native model's, FFBS and iterated CSMC against RTS, particle
Gibbs (8 chains pooled as one bank) and SMC² against the prior-IS oracle. On
the CPU no propagate kernel's plain version runs for a DSL model, while the
resample goes through K1's or K3's wrapper."""
import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import sequential_monte_carlo_tpu as jsmc
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu.distributions import Normal as JNormal
from sequential_monte_carlo_tpu_torch.distributions import Normal
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.kernels import propagate as kprop
from sequential_monte_carlo_tpu_torch.kernels import resample_sorted as ksorted
from sequential_monte_carlo_tpu_torch.kernels import resample_walk as kwalk
from sequential_monte_carlo_tpu_torch.kernels import ucsv as kucsv
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf
from sequential_monte_carlo_tpu_torch.samplers.particle_gibbs import _particle_gibbs_bank

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

THETA = (0.5, 0.9, 0.8)  # the LG θ* = (A, Q, R)
LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _ucsv_program(lib, normal, params=("gamma", "sx0", "sy0"), defaults=None):
    """The macro docstring's UC-SV program (macros.jl:9-26) in ``lib``
    (``jnp`` or ``torch``)."""
    return dict(
        params=params,
        defaults=dict(x0=0.0) if defaults is None else defaults,
        init=lambda p: dict(
            x=normal(p["x0"], lib.exp(0.5 * p["sx0"])),
            sx=normal(p["sx0"], p["gamma"]),
            sy=normal(p["sy0"], p["gamma"]),
        ),
        transition=lambda p, prev: dict(
            x=normal(prev["x"], lib.exp(0.5 * prev["sx"])),
            sx=normal(prev["sx"], p["gamma"]),
            sy=normal(prev["sy"], p["gamma"]),
        ),
        observe=lambda p, s: normal(s["x"], lib.exp(0.5 * s["sy"])),
    )


@pytest.fixture(scope="module")
def ucsv_spec():
    return tsmc.ssm_model("ucsv", **_ucsv_program(torch, Normal))


def _ucsv4(lib, normal):
    """UC-SV in ``ucsv_model``'s θ layout (γ shared, x0, log σε0, log ση0)."""
    return dict(
        params=("gamma", "x0", "lse0", "lsn0"),
        init=lambda p: dict(
            x=normal(p["x0"], lib.exp(0.5 * p["lse0"])),
            lse=normal(p["lse0"], p["gamma"]),
            lsn=normal(p["lsn0"], p["gamma"]),
        ),
        transition=lambda p, prev: dict(
            x=normal(prev["x"], lib.exp(0.5 * prev["lse"])),
            lse=normal(prev["lse"], p["gamma"]),
            lsn=normal(prev["lsn"], p["gamma"]),
        ),
        observe=lambda p, s: normal(s["x"], lib.exp(0.5 * s["lsn"])),
    )


def _ar1_spec():
    """lg_model written with ssm_model: x₁ ~ N(0, 1), x_t ~ N(a x_{t−1}, q),
    y_t ~ N(x_t, r); no fused kernel."""
    return tsmc.ssm_model(
        "ar1", params=("a", "q", "r"),
        init=lambda p: dict(x=Normal(0.0, 1.0)),
        transition=lambda p, prev: dict(x=Normal(p["a"] * prev["x"], torch.sqrt(p["q"]))),
        observe=lambda p, s: Normal(s["x"], torch.sqrt(p["r"])),
    )


def _kalman_target_logz(y) -> float:
    """The Kalman log Z of the filter's own target at θ* (the filter draws
    x₁ ~ N(0, 1); the Kalman filter predicts x₁ from Σ0' = (Σ0 − Q)/A²)."""
    a, q, r = THETA
    target = tsmc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2,
                                             device="cpu")
    return tsmc.kalman_log_likelihood(target, y)[1].item()


def _delta_ok(lz, kz: float) -> bool:
    """E[Ẑ] = Z: the rows' mean + var/2 within 5 standard errors of log Z."""
    lz = lz.double().numpy()
    m, var = lz.shape[0], lz.var(ddof=1)
    se = math.sqrt(var / m + var**2 / (2 * (m - 1)))
    return bool(np.all(np.isfinite(lz)) and abs(lz.mean() + var / 2 - kz) < 5 * se)


# -- the JAX DSL tests' counterparts ------------------------------------------

def test_introspection(ucsv_spec):
    assert ucsv_spec.get_parameters() == ("gamma", "sx0", "sy0", "x0")
    assert ucsv_spec.get_states() == ("x", "sx", "sy")


def test_free_parameter_inference():
    """``params`` omitted: the free names in first-access order, defaults
    excluded — the probe hands the torch functions 0-d tensors."""
    prog = _ucsv_program(torch, Normal)
    del prog["params"]
    spec = tsmc.ssm_model("ucsv_inferred", **prog)
    assert spec.get_states() == ("x", "sx", "sy")
    assert spec.get_parameters() == ("sx0", "gamma", "sy0", "x0")
    x, y = tsmc.simulate(_gen(0), spec([-1.0, 0.2, -1.0], device="cpu"), 20)
    assert x.shape == (20, 3) and y.shape == (20,)


def test_inference_observe_only_param():
    """A parameter read only by ``observe`` is found; plain numbers in the
    functions are taken."""
    spec = tsmc.ssm_model(
        "ar_noise",
        init=lambda p: dict(x=Normal(0.0, 1.0)),
        transition=lambda p, prev: dict(x=Normal(p["a"] * prev["x"], 1.0)),
        observe=lambda p, s: Normal(s["x"], p["r"]),
    )
    assert spec.get_parameters() == ("a", "r")
    assert spec.get_states() == ("x",)
    _, y = tsmc.simulate(_gen(1), spec([0.5, 0.7], device="cpu"), 10)
    assert torch.isfinite(y).all()


def test_wrong_theta_length(ucsv_spec):
    with pytest.raises(ValueError, match="expected 3 free parameters"):
        ucsv_spec(torch.zeros(5))


def test_simulate_and_filter(ucsv_spec):
    model = ucsv_spec(torch.tensor([0.2, -1.0, -1.0]))
    assert model.state_dim == 3 and isinstance(model, tsmc.StateSpaceModel)
    x, y = tsmc.simulate(_gen(0), model, 50)
    assert x.shape == (50, 3)
    state, z = tsmc.log_likelihood(_gen(1), model, 512, y)
    assert math.isfinite(z.item()) and state.particles.shape == (512, 3)


def test_default_override(ucsv_spec):
    m = ucsv_spec(torch.tensor([0.2, -1.0, -1.0]), x0=5.0)
    x0 = m.initial_distribution().sample(_gen(0), (4000,))[:, 0]
    assert abs(x0.mean().item() - 5.0) < 0.1


def test_single_state_model():
    """A single-state model keeps a (1,) state axis (macros.jl:95-99)."""
    spec = tsmc.ssm_model(
        "ar1", params=("a", "q"),
        init=lambda p: dict(x=Normal(torch.tensor(0.0), torch.tensor(1.0))),
        transition=lambda p, prev: dict(x=Normal(p["a"] * prev["x"], torch.sqrt(p["q"]))),
        observe=lambda p, s: Normal(s["x"], torch.tensor(1.0)),
    )
    x, _ = tsmc.simulate(_gen(0), spec(torch.tensor([0.5, 0.9])), 30)
    assert x.shape == (30, 1)


def test_dsl_in_smc2(ucsv_spec):
    """The spec as an SMC² model_fn, on an (M, 3) θ-cloud."""
    prior = tsmc.product_distribution([
        tsmc.Uniform(torch.tensor(0.01), torch.tensor(1.0)),
        tsmc.Normal(torch.tensor(-1.0), torch.tensor(1.0)),
        tsmc.Normal(torch.tensor(-1.0), torch.tensor(1.0)),
    ])
    _, y = tsmc.simulate(_gen(6), ucsv_spec(torch.tensor([0.2, -1.0, -1.0])), 30)
    sampler = tsmc.SMC2(ucsv_spec, prior, tsmc.SMCConfig(n_particles=64, n_theta=32, chain=2))
    state, infos = sampler.run(_gen(7), y)
    assert math.isfinite(state.ess.item()) and state.particles.shape == (32, 64, 3)
    assert int(infos.rejuvenated.sum()) > 0


# -- exact: densities ---------------------------------------------------------

def _states(rng, shape):
    return np.stack([rng.normal(3.0, 1.0, shape), rng.normal(-1.0, 0.5, shape),
                     rng.normal(-1.0, 0.5, shape)], -1).astype(np.float32)


def test_same_program_in_jnp_and_torch():
    """The macro's UC-SV program written with jnp and with torch: the
    initial, transition and observation log-densities at the same numpy θ,
    states and y agree to 1e-6 relative."""
    rng = np.random.default_rng(3)
    theta = np.array([0.3, -0.8, -1.2], np.float32)
    jspec = jsmc.ssm_model("ucsv", **_ucsv_program(jnp, JNormal))
    tspec = tsmc.ssm_model("ucsv", **_ucsv_program(torch, Normal))
    jm, tm = jspec(jnp.asarray(theta)), tspec(torch.from_numpy(theta))
    prev, x = _states(rng, (64,)), _states(rng, (64,))
    y = rng.normal(3.0, 1.0, 64).astype(np.float32)
    pairs = [
        (jm.initial_distribution().log_prob(jnp.asarray(x)),
         tm.initial_distribution().log_prob(torch.from_numpy(x))),
        (jm.transition_distribution(jnp.asarray(prev)).log_prob(jnp.asarray(x)),
         tm.transition_distribution(torch.from_numpy(prev)).log_prob(torch.from_numpy(x))),
        (jm.observation_distribution(jnp.asarray(x)).log_prob(jnp.asarray(y)),
         tm.observation_distribution(torch.from_numpy(x)).log_prob(torch.from_numpy(y))),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_dsl_ucsv_densities_equal_the_native_model():
    """The UC-SV program in ucsv_model's θ layout, on an (M, 4) θ-cloud and
    (N, M, 3) states (the batched filter's layout): its three densities and
    its transition mean equal the native UCSVModel's."""
    rng = np.random.default_rng(4)
    theta = torch.from_numpy(np.stack([rng.uniform(0.05, 0.5, 5), rng.normal(3.0, 1.0, 5),
                                       rng.uniform(0.0, 1.0, 5), rng.uniform(0.0, 1.0, 5)],
                                      1).astype(np.float32))
    dsl = tsmc.ssm_model("ucsv4", **_ucsv4(torch, Normal))(theta)
    native = tsmc.ucsv_model(theta)
    x, prev = torch.from_numpy(_states(rng, (7, 5))), torch.from_numpy(_states(rng, (7, 5)))
    y = torch.tensor(2.5)
    for a, b in [(dsl.initial_distribution().log_prob(x), native.initial_distribution().log_prob(x)),
                 (dsl.transition_distribution(prev).log_prob(x),
                  native.transition_distribution(prev).log_prob(x)),
                 (dsl.transition_distribution(prev).mean(),
                  native.transition_distribution(prev).mean()),
                 (dsl.observation_distribution(x).log_prob(y),
                  native.observation_distribution(x).log_prob(y))]:
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("algorithm", ["bootstrap", "apf"])
def test_dsl_ucsv_log_z_matches_the_native_model(algorithm):
    """64 DSL UC-SV filters (the plain propagate route) and 64 native ones
    (the kernels' plain versions) at one θ on a simulated series (N=256,
    T=60): the mean log Ẑ agree within 5 combined standard errors."""
    theta = torch.tensor([0.2, 3.0, -1.0, -1.0])
    m, cfg = 64, tsmc.PFConfig("systematic", 1.0, algorithm=algorithm)
    _, y = tsmc.simulate(_gen(3), tsmc.ucsv_model(theta), 60)
    bank = theta.expand(m, 4)
    dsl = tsmc.ssm_model("ucsv4", **_ucsv4(torch, Normal))
    lz_d = tsmc.batched_log_likelihood(_gen(4), dsl(bank), 256, m, y, cfg)[2].double()
    lz_n = tsmc.batched_log_likelihood(_gen(5), tsmc.ucsv_model(bank), 256, m, y, cfg)[2].double()
    se = math.sqrt(lz_d.var().item() / m + lz_n.var().item() / m)
    assert torch.isfinite(lz_d).all()
    assert abs(lz_d.mean().item() - lz_n.mean().item()) < 5 * se, (lz_d.mean(), lz_n.mean(), se)


def _linear_decls(lib):
    """Declarations for ``linear_ssm_model`` in ``lib``: the README's AR(1)
    and a local linear trend (dx = 2)."""
    return {
        "ar1": dict(params=("a", "q", "r"), A=lambda p: p["a"], B=lambda p: 1.0,
                    Q=lambda p: p["q"], R=lambda p: p["r"], x0=lambda p: 0.0,
                    sigma0=lambda p: 1.0),
        "trend2": dict(params=("q", "r"), A=lambda p: lib.asarray([[1.0, 1.0], [0.0, 1.0]]),
                       B=lambda p: lib.asarray([1.0, 0.0]),
                       Q=lambda p: p["q"][..., None, None] * lib.asarray([[0.25, 0.5],
                                                                          [0.5, 1.0]]),
                       R=lambda p: p["r"], x0=lambda p: lib.asarray([3.0, 0.0]),
                       sigma0=lambda p: lib.asarray([[1.0, 0.0], [0.0, 0.1]])),
    }


@pytest.mark.parametrize("decl", ["ar1", "trend2"])
def test_linear_ssm_model_kalman_matches_jax(decl):
    """The same declaration in both packages: the port's constructor gives
    a LinearGaussianModel whose Kalman log Z on the same numpy series is the
    JAX package's to 1e-5 relative, on one θ and row by row on a θ-cloud."""
    theta = np.array({"ar1": THETA, "trend2": (0.3, 0.8)}[decl], np.float32)
    t_ctor = tsmc.linear_ssm_model(decl, **_linear_decls(torch)[decl])
    j_ctor = jsmc.linear_ssm_model(decl, **_linear_decls(jnp)[decl])
    assert t_ctor.get_parameters() == j_ctor.get_parameters()
    y = chip_smoke.lg_series(50)
    model = t_ctor(torch.from_numpy(theta))
    assert isinstance(model, tsmc.LinearGaussianModel)
    z = tsmc.kalman_log_likelihood(model, torch.from_numpy(y))[1].item()
    zj = float(jsmc.kalman_log_likelihood(j_ctor(jnp.asarray(theta)), jnp.asarray(y))[1])
    assert z == pytest.approx(zj, rel=1e-5)
    bank = t_ctor(torch.from_numpy(np.stack([theta, theta * 1.1])))
    zb = tsmc.kalman_log_likelihood(bank, torch.from_numpy(y))[1]
    assert bank.A.shape[0] == 2 and zb[0].item() == pytest.approx(zj, rel=1e-5)


def test_linear_ssm_model_runs_ibis():
    """The declared AR(1) inside IBIS (the exact Kalman bank): its
    posterior within the JAX tests' 0.3 of the prior-IS oracle."""
    ar1 = tsmc.linear_ssm_model("ar1", **_linear_decls(torch)["ar1"])
    prior = prior_from_spec(LG_PRIOR, device="cpu")
    y = torch.from_numpy(chip_smoke.lg_series(50))
    state, _ = tsmc.IBIS(ar1, prior, tsmc.SMCConfig(n_theta=256, chain=2)).run(_gen(1), y)
    assert math.isfinite(state.ess.item())
    theta = prior.sample(_gen(77), (100_000,))
    lz = tsmc.kalman_log_likelihood(tsmc.lg_model(theta), y)[1]
    oracle = torch.softmax(lz.double(), 0) @ theta.double()
    assert torch.all((tsmc.expected_parameters(state).double() - oracle).abs() < 0.3)


# -- the plain propagate route ------------------------------------------------

ROUTES = {
    "systematic": dict(inner=("systematic", 1.0)),
    "stratified": dict(inner=("stratified", 1.0)),
    "multinomial": dict(inner=("multinomial", 1.0)),
    "residual": dict(inner=("residual", 1.0)),
    "residual_systematic": dict(inner=("residual_systematic", 1.0)),
    "metropolis": dict(inner=("metropolis", 1.0)),
    "systematic_adaptive": dict(inner=("systematic", 0.5)),
    "stratified_adaptive": dict(inner=("stratified", 0.5)),
    "elastic_systematic": dict(inner=("systematic", 1.0), active_n=192),
    "elastic_stratified_adaptive": dict(inner=("stratified", 0.5), active_n=192),
    "apf": dict(inner=("systematic", 1.0, None, "apf")),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_plain_route_log_z_matches_kalman(route):
    """A DSL AR(1) at θ*, 64 rows, N=256 (or 192 live of 256), T=40, on each
    inner route: mean + var/2 of log Ẑ within 5 standard errors of the
    Kalman log Z of the filter's target; the weights normalized, the dead
    tail at −inf."""
    spec = ROUTES[route]
    m, n = 64, 256
    y = torch.from_numpy(chip_smoke.lg_series(40))
    _, lw, lz = tsmc.batched_log_likelihood(_gen(0), _ar1_spec()(torch.tensor(THETA).expand(m, 3)),
                                            n, m, y, tsmc.PFConfig(*spec["inner"]),
                                            active_n=spec.get("active_n"))
    np.testing.assert_allclose(torch.logsumexp(lw, 1).numpy(), 0.0, atol=1e-5)
    if "active_n" in spec:
        assert torch.all(lw[:, spec["active_n"]:] == -torch.inf)
    assert _delta_ok(lz, _kalman_target_logz(y)), lz


@pytest.fixture
def plain_calls(monkeypatch):
    """Count the resample kernels' plain versions (what their wrappers run
    on the CPU) and make every propagate kernel's plain version raise."""
    calls = {"count": 0, "sorted": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    def refuse(*a, **kw):
        raise AssertionError("a propagate kernel ran for a model without one")

    monkeypatch.setattr(kwalk, "resample_gather_plain", counted("count", kwalk.resample_gather_plain))
    monkeypatch.setattr(ksorted, "resample_gather_sorted_plain",
                        counted("sorted", ksorted.resample_gather_sorted_plain))
    monkeypatch.setattr(kprop, "fused_elementwise_step_plain", refuse)
    monkeypatch.setattr(kucsv, "ucsv_propagate_reweight_plain", refuse)
    return calls


@pytest.mark.parametrize("inner, active_n, kernel", [
    (("systematic", 1.0), None, "count"),
    (("stratified", 0.5), None, "sorted"),
    (("systematic", 1.0), 48, "sorted"),
    (("systematic", 1.0, None, "apf"), None, "count"),
])
def test_plain_route_takes_the_resample_kernels_only(plain_calls, inner, active_n, kernel):
    """A DSL UC-SV bank (the native model's θ layout) on the bootstrap, the
    ESS-triggered, the elastic and the auxiliary route: every step's
    resample goes through K1's or K3's wrapper, no propagate kernel's plain
    version runs, and ``_draws`` hands the step the generator, not a Philox
    seed or normals."""
    bank = tsmc.ssm_model("ucsv4", **_ucsv4(torch, Normal))(
        torch.tensor([0.2, 3.0, -1.0, -1.0]).expand(8, 4))
    cfg = tsmc.PFConfig(*inner)
    gen = _gen(2)
    assert tbf._draws(gen, bank, 8, 64, torch.device("cpu"), cfg, active_n)[1] is gen
    y = torch.from_numpy(chip_smoke.ucsv_series(12))
    tsmc.batched_log_likelihood(gen, bank, 64, 8, y, cfg, active_n=active_n)
    assert plain_calls[kernel] == 11 and sum(plain_calls.values()) == 11


def test_per_theta_smoothing_and_csmc_take_no_propagate_kernel(plain_calls):
    """The per-θ filters, FFBS, the posterior mixture and both CSMC methods
    run a DSL model without any propagate kernel."""
    model = _ar1_spec()(torch.tensor(THETA))
    y = torch.from_numpy(chip_smoke.lg_series(10))
    tsmc.filter_sequence(_gen(0), model, 32, y)
    tsmc.apf_log_likelihood(_gen(0), model, 32, y)
    tsmc.smoothed_marginals(_gen(0), model, 32, y)
    tsmc.posterior_smoothed_paths(_gen(0), _ar1_spec(), torch.tensor(THETA).expand(4, 3),
                                  torch.zeros(4), y, n=32, n_theta=2, n_paths=3)
    for method in ("bs", "as"):
        tsmc.csmc_sweep(_gen(1), model, 32, y, torch.zeros((10, 1)), method=method)
    assert plain_calls["count"] == 4 * 9 and plain_calls["sorted"] == 0


@pytest.fixture(scope="module")
def rts():
    """chip_smoke's LG series (T=40) and the RTS means and sds of the
    filter's target."""
    a, q, r = THETA
    y = torch.from_numpy(chip_smoke.lg_series(40))
    target = tsmc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2,
                                             device="cpu")
    ms, ps = tsmc.kalman_smooth(target, y)
    return y, ms[:, 0].numpy(), torch.sqrt(ps[:, 0, 0]).numpy()


def test_dsl_ffbs_matches_rts(rts):
    """FFBS marginals of the DSL AR(1) at N=512: smoothed means within 0.5
    sd of RTS at every t and 0.15 sd on average."""
    y, ms, sd = rts
    sm = tsmc.smoothed_marginals(_gen(3), _ar1_spec()(torch.tensor(THETA)), 512, y)
    err = np.abs(tsmc.smoothed_mean(sm)[:, 0].numpy() - ms) / sd
    assert err.max() < 0.5 and err.mean() < 0.15, (err.max(), err.mean())


@pytest.mark.parametrize("method", ["bs", "as"])
def test_dsl_csmc_invariance_matches_rts(rts, method):
    """Iterated CSMC on the DSL AR(1) at θ* (N=256, 120 sweeps from a bad
    start): the pooled path means of the last 80 within 0.75 sd of RTS at
    every t and 0.3 sd on average (the port's native CSMC test's bounds)."""
    y, ms, sd = rts
    model, gen, path, paths = _ar1_spec()(torch.tensor(THETA)), _gen(7), torch.zeros((40, 1)), []
    for _ in range(120):
        path = tsmc.csmc_sweep(gen, model, 256, y, path, method=method).path
        paths.append(path[:, 0])
    err = np.abs(torch.stack(paths[40:]).mean(0).numpy() - ms) / sd
    assert err.max() < 0.75 and err.mean() < 0.3, (err.max(), err.mean())


@pytest.fixture(scope="module")
def lg_oracle():
    """chip_smoke's LG series (T=60), the LG prior, and the prior-IS
    posterior mean (100,000 draws, Kalman log Z)."""
    prior = prior_from_spec(LG_PRIOR, device="cpu")
    y = torch.from_numpy(chip_smoke.lg_series(60))
    theta = prior.sample(_gen(77), (100_000,))
    lz = tsmc.kalman_log_likelihood(tsmc.lg_model(theta), y)[1]
    return prior, y, (torch.softmax(lz.double(), 0) @ theta.double()).numpy()


def test_dsl_particle_gibbs_matches_oracle(lg_oracle):
    """Particle Gibbs on the DSL AR(1), 8 chains as one bank (N=128, 200
    sweeps, chain=3): the θ-chain means after 75 sweeps, pooled, within the
    JAX tests' 0.3 of the oracle; each acceptance in (0.1, 0.6)."""
    prior, y, oracle = lg_oracle
    gen = _gen(11)
    res = _particle_gibbs_bank(gen, _ar1_spec(), prior, y,
                               tsmc.PGConfig(n_particles=128, sweeps=200, chain=3),
                               prior.sample(gen, (8,)))
    assert torch.all((0.1 < res.acc_ratio) & (res.acc_ratio < 0.6)), res.acc_ratio
    got = res.theta[75:].mean(0).numpy().mean(0)
    assert np.all(np.abs(got - oracle) < 0.3), (got, oracle)


def test_dsl_smc2_posterior_matches_oracle(lg_oracle):
    """Online SMC² on the DSL AR(1) (M=128, N=128, chain=3): the posterior
    mean within the JAX tests' 0.3 of the oracle."""
    prior, y, oracle = lg_oracle
    sampler = tsmc.SMC2(_ar1_spec(), prior, tsmc.SMCConfig(n_particles=128, n_theta=128, chain=3))
    state, _ = sampler.run(_gen(5), y)
    got = tsmc.expected_parameters(state).numpy()
    assert np.all(np.abs(got - oracle) < 0.3), (got, oracle)


def test_broadcast_model_carries_non_tensor_fields():
    """broadcast_model lifts a DSL model (its θ the one tensor field; name,
    state names and functions carried through) to a bank whose rows are the
    model."""
    model = _ar1_spec()(torch.tensor(THETA))
    bank = tsmc.broadcast_model(model, 3)
    assert bank.theta.shape == (3, 3) and bank.init_fn is model.init_fn
    assert bank.state_names == ("x",) and bank.name == "ar1"
    x = torch.randn((5, 3, 1), generator=_gen(0))
    torch.testing.assert_close(bank.transition_distribution(x).log_prob(x),
                               model.transition_distribution(x).log_prob(x))


def test_ucsv_keyword_constructor():
    """unobserved_components_stochastic_volatility ≡ ucsv_model at the same
    numbers, on the device asked for (the card by default, as every
    constructor given only numbers)."""
    m = tsmc.unobserved_components_stochastic_volatility(3.0, 0.2, 0.2, -1.0, -1.0, device="cpu")
    ref = tsmc.ucsv_model(torch.tensor([0.2, 3.0, -1.0, -1.0]))
    x = torch.randn((4, 3), generator=_gen(1))
    torch.testing.assert_close(m.transition_distribution(x).log_prob(x),
                               ref.transition_distribution(x).log_prob(x))
    assert m.x0.device.type == "cpu" and m.state_dim == 3


def test_constructors_given_numbers_default_to_the_card():
    """The UC-SV keyword constructor, a DSL spec and a linear_ssm_model
    constructor put numbers on the card unless asked for another device; a
    θ tensor keeps its device."""
    ucsv = tsmc.unobserved_components_stochastic_volatility
    spec = _ar1_spec()
    ar1 = tsmc.linear_ssm_model("ar1", **_linear_decls(torch)["ar1"])
    for fn in (ucsv, spec.__call__, ar1):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert ucsv(3.0, 0.2, 0.2, -1.0, -1.0, device="meta").x0.device.type == "meta"
    assert spec(list(THETA), device="meta").theta.device.type == "meta"
    assert ar1(list(THETA), device="meta").A.device.type == "meta"
    assert spec(torch.tensor(THETA), device="meta").theta.device.type == "cpu"
