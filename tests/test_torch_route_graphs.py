"""The inner routes that the port's compiled loops (``ops/graphs.py``) take
beyond the fused kernels: a ``@model`` DSL model's plain propagate route,
the guided proposal, and the residual and metropolis resamplers, on every
loop that replays — the masked filter, SMC²'s online step,
``filter_sequence``, the forward bank, conditional SMC and particle Gibbs —
and the rule that keeps a step running ``torch.linalg.eigh`` (an
``MvNormal`` with ``allow_singular``) off the graphs.

On the CPU nothing is captured: with ``batched_filter.captures`` answering
as it would on the card (the ``routed`` fixture), every loop runs through
its route (the warm-up and its undo, the buffers, the loads, the replays
grouped as the graphs would launch them) with each body run eagerly, and
is held bit for bit against the eager loop. The replays themselves are
held against their ``disable_graphs()`` twins on the card (the ``gpu``
cases at the end), which skip here. Only the posterior test imports JAX,
inside it, so that the card runs this file without JAX:

    python -m pytest --noconftest tests/test_torch_route_graphs.py -m gpu
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.analysis import weighted_quantile
from sequential_monte_carlo_tpu_torch.distributions.core import _as_like
from sequential_monte_carlo_tpu_torch.distributions.mvnormal import eigh
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.models.dsl import _tensor_fields
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf
from sequential_monte_carlo_tpu_torch.ops import graphs
from sequential_monte_carlo_tpu_torch.samplers.particle_gibbs import _particle_gibbs_bank

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

S = graphs.STEPS_PER_GRAPH
M, N, T = 16, 64, 24
BENCH_PRIOR = [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
               ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)]
LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
INNER = {"systematic": ("systematic", 1.0), "stratified_ess": ("stratified", 0.5),
         "apf": ("systematic", 1.0, None, "apf"), "residual": ("residual", 1.0),
         "metropolis": ("metropolis", 1.0)}


def _ucsv4_program(lib, normal):
    """UC-SV in ``ucsv_model``'s θ layout (γ, x0, log σε0, log ση0) as a DSL
    program in ``lib`` (``torch`` or ``jnp``)."""
    return dict(
        params=("gamma", "x0", "lse0", "lsn0"),
        init=lambda p: dict(x=normal(p["x0"], lib.exp(0.5 * p["lse0"])),
                            lse=normal(p["lse0"], p["gamma"]),
                            lsn=normal(p["lsn0"], p["gamma"])),
        transition=lambda p, prev: dict(x=normal(prev["x"], lib.exp(0.5 * prev["lse"])),
                                        lse=normal(prev["lse"], p["gamma"]),
                                        lsn=normal(prev["lsn"], p["gamma"])),
        observe=lambda p, s: normal(s["x"], lib.exp(0.5 * s["lsn"])),
    )


# one spec each, so that every call keys the same route (its functions)
UCSV4 = tsmc.ssm_model("ucsv4", **_ucsv4_program(torch, tsmc.Normal))
AR1 = tsmc.ssm_model(  # numbers in the functions: fills on θ's device
    "ar1", params=("a", "q", "r"),
    init=lambda p: dict(x=tsmc.Normal(0.0, 1.0)),
    transition=lambda p, prev: dict(x=tsmc.Normal(p["a"] * prev["x"], torch.sqrt(p["q"]))),
    observe=lambda p, s: tsmc.Normal(s["x"], torch.sqrt(p["r"])))
SPECS = {"dsl_ucsv": UCSV4, "dsl_ar1": AR1, "ucsv": tsmc.ucsv_model, "lg": tsmc.lg_model}


def _theta(kind, m, seed):
    """An (m, k) θ bank drawn with numpy: UC-SV (γ, x0, log σε0, log ση0)
    or AR(1)/LG (a, q, r)."""
    rng = np.random.default_rng(seed)
    if kind.endswith("ucsv"):
        theta = np.c_[rng.uniform(0.1, 0.4, m), rng.normal(3.0, 0.5, m),
                      rng.normal(-1.0, 0.3, m), rng.normal(-1.0, 0.3, m)]
    else:
        theta = np.c_[rng.uniform(0.3, 0.9, m), rng.uniform(0.5, 1.0, m),
                      rng.uniform(0.5, 1.0, m)]
    return torch.tensor(theta, dtype=torch.float32)


def _bank(kind, m=M, seed=0, device="cpu"):
    return SPECS[kind](_theta(kind, m, seed).to(device))


def _series(t, seed=1998):
    """bench.py's synthetic inflation-like series, first t points."""
    rng = np.random.default_rng(seed)
    y = 3.0 + np.cumsum(rng.normal(0, 0.3, 241)) + rng.normal(0, 0.5, 241)
    return torch.from_numpy(y.astype(np.float32)[:t])


def _lg_series(t, seed=7):
    """An AR(1) series at (a, q, r) = (0.5, 0.9, 0.8)."""
    rng = np.random.default_rng(seed)
    x, ys = rng.normal(), []
    for _ in range(t):
        x = 0.5 * x + math.sqrt(0.9) * rng.normal()
        ys.append(x + math.sqrt(0.8) * rng.normal())
    return torch.tensor(ys, dtype=torch.float32)


def _y(kind, t):
    return _series(t) if kind.endswith("ucsv") else _lg_series(t)


def _widened():
    """A guided ``Product(Normal)`` proposal: the LG (or AR(1)) transition
    with its scale widened 1.5-fold."""
    def step(mm, xp):
        if isinstance(mm, tsmc.LinearGaussianModel):
            a, sd = mm.A[..., 0, :], torch.sqrt(mm.Q[..., 0, :])
        else:
            a, sd = mm.theta[..., 0:1], torch.sqrt(mm.theta[..., 1:2])
        return tsmc.Product(tsmc.Normal(a * xp, 1.5 * sd))

    return tsmc.Proposal(initial=lambda mm: mm.initial_distribution(), step=step)


def _transition():
    """The bootstrap's proposal written as a guided one (its own route)."""
    return tsmc.Proposal(initial=lambda mm: mm.initial_distribution(),
                         step=lambda mm, xp: mm.transition_distribution(xp))


GUIDED, BOOTSTRAP_AS_GUIDED = _widened(), _transition()


def _config(inner):
    if inner == "guided":
        return tsmc.PFConfig(proposal=GUIDED)
    return tsmc.PFConfig(*INNER[inner])


@pytest.fixture
def routed(monkeypatch):
    """``captures`` as on the card: the loops take their routes on the CPU
    (the bodies run eagerly through the buffers)."""
    captures = tbf.captures
    monkeypatch.setattr(tbf, "captures", lambda config, active_n, device: captures(
        config, active_n, torch.device("cuda")))
    graphs.clear_graphs()
    yield
    graphs.clear_graphs()


def _routes(kind: str):
    return [r for key, r in graphs._cache.items() if key[0] == kind]


def _assert_equal(got, ref):
    for a, b in zip(graphs._leaves(got), graphs._leaves(ref), strict=True):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _masked(seed, models, y, mask, config, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    out = tbf.batched_log_likelihood_masked(gen, models, N, _rows(models), y, mask, config)
    return out, gen.get_state()


def _rows(models) -> int:
    """The bank's M: its first tensor field's leading axis."""
    return next(v.shape[0] for v in (getattr(models, f.name) for f in dataclasses.fields(models))
                if isinstance(v, torch.Tensor))


def _mask(t, seed=11):
    """Live times with holes (mask[0] is always 1)."""
    mask = (np.random.default_rng(seed).uniform(size=t) < 0.8).astype(np.float32)
    mask[0] = 1.0
    return torch.from_numpy(mask)


# -- the masked filter --------------------------------------------------------

@pytest.mark.parametrize("inner", ["systematic", "stratified_ess", "apf"])
@pytest.mark.parametrize("kind", ["dsl_ucsv", "dsl_ar1"])
def test_dsl_masked_route_equals_eager(routed, kind, inner):
    """A DSL bank's masked filter through its route (the plain propagate
    route inside the step body: the draw, the observation density, the
    copies into the ping-pong buffers) bitwise its eager loop: particles,
    log-weights, log Z and the generator's state; ⌊L/S⌋ + L mod S
    replays."""
    models, y, mask = _bank(kind), _y(kind, T), _mask(T)
    cfg = _config(inner)
    got = _masked(3, models, y, mask, cfg)
    (route,) = _routes("masked")
    live = int((mask[1:] > 0).sum())
    assert route.replays == live // S + live % S and not route.runs_eigh
    with tsmc.disable_graphs():
        ref = _masked(3, models, y, mask, cfg)
    _assert_equal(got, ref)


@pytest.mark.parametrize("kind,inner", [
    ("lg", "guided"), ("lg", "residual"), ("lg", "metropolis"), ("ucsv", "residual"),
    ("ucsv", "metropolis"), ("dsl_ar1", "guided"), ("dsl_ar1", "residual"),
    ("dsl_ucsv", "metropolis")])
def test_inner_route_masked_equals_eager(routed, kind, inner):
    """The guided ``Product(Normal)`` proposal and the residual and
    metropolis resamplers (their ancestors drawn inside the step), on the
    zoo's kernels and on a DSL model, through the masked filter's route,
    bitwise the eager loop."""
    models, y, mask = _bank(kind), _y(kind, T), _mask(T)
    cfg = _config(inner)
    got = _masked(4, models, y, mask, cfg)
    assert len(_routes("masked")) == 1
    with tsmc.disable_graphs():
        ref = _masked(4, models, y, mask, cfg)
    _assert_equal(got, ref)


@pytest.mark.parametrize("kind,inner", [("dsl_ucsv", "systematic"), ("lg", "guided"),
                                        ("lg", "metropolis"), ("ucsv", "residual")])
def test_second_run_on_the_cached_route(routed, kind, inner):
    """A second run with a new generator, bank and mask through the cached
    route (no new route, its buffers loaded again) equals a fresh eager run
    of it bit for bit."""
    cfg, y = _config(inner), _y(kind, T)
    _masked(1, _bank(kind, seed=0), y, _mask(T, 1), cfg)
    (route,) = _routes("masked")
    replays = route.replays
    got = _masked(2, _bank(kind, seed=5), y, _mask(T, 2), cfg)
    assert _routes("masked") == [route] and route.replays > replays
    with tsmc.disable_graphs():
        ref = _masked(2, _bank(kind, seed=5), y, _mask(T, 2), cfg)
    _assert_equal(got, ref)


def test_two_proposals_take_two_routes(routed):
    """Two proposals at one configuration key two routes (the proposals'
    functions by identity); each run equals its eager twin, and a third
    run with the first proposal takes the first route again."""
    models, y, mask = _bank("lg"), _y("lg", T), _mask(T)
    runs = {}
    for name, proposal in (("widened", GUIDED), ("transition", BOOTSTRAP_AS_GUIDED)):
        cfg = tsmc.PFConfig(proposal=proposal)
        runs[name] = _masked(5, models, y, mask, cfg)
        with tsmc.disable_graphs():
            _assert_equal(runs[name], _masked(5, models, y, mask, cfg))
    first, second = _routes("masked")
    assert first is not second
    _masked(6, models, y, mask, tsmc.PFConfig(proposal=GUIDED))
    assert len(graphs._cache) == 2 and first.replays == second.replays * 2
    assert not torch.equal(runs["widened"][0][2], runs["transition"][0][2])


# -- the eigh rule -------------------------------------------------------------

def _lg2(m=M, seed=0, device="cpu"):
    """An LG bank at dx = 2 (a singular Q, as Hodrick–Prescott's, on half
    the rows)."""
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.uniform(0.3, 0.8, (m, 2)), dtype=torch.float32)
    q = torch.tensor(rng.uniform(0.5, 1.0, (m, 2)), dtype=torch.float32)
    q[: m // 2, 1] = 0.0
    fields = dict(A=torch.diag_embed(a), B=torch.ones(m, 2), Q=torch.diag_embed(q),
                  R=torch.full((m,), 0.8), x0=torch.zeros(m, 2),
                  sigma0=torch.eye(2).expand(m, 2, 2))
    return tsmc.LinearGaussianModel(**{k: v.to(device) for k, v in fields.items()})


@pytest.mark.parametrize("case,runs_eigh", [
    ("mvnormal_guided", True), ("lg2_transition_guided", True), ("lg2_bootstrap", False),
    ("dsl_guided", False)])
def test_eigh_rule_keeps_the_bodies_eager(routed, case, runs_eigh):
    """A step that runs ``torch.linalg.eigh`` (an ``MvNormal`` proposal, or
    the guided increment's LG transition density at dx = 2) is found in the
    route's warm-up: the route runs its bodies eagerly (no graphs, on the
    card too), bitwise the eager loop; the bootstrap on the same bank (its
    kernel parameters packed outside the step) and a DSL model do not run
    it. The warm-up's eigh calls are undone with the rest."""
    models = _lg2() if case.startswith(("mvnormal", "lg2")) else _bank("dsl_ar1")
    proposal = {"mvnormal_guided": tsmc.Proposal(
        initial=lambda mm: mm.initial_distribution(),
        step=lambda mm, xp: tsmc.MvNormal((mm.A @ xp[..., None])[..., 0], 2.0 * mm.Q)),
        "lg2_transition_guided": BOOTSTRAP_AS_GUIDED, "lg2_bootstrap": None,
        "dsl_guided": GUIDED}[case]
    cfg, y, mask = tsmc.PFConfig(proposal=proposal), _lg_series(T), _mask(T)
    with tsmc.disable_graphs():
        calls = eigh.calls
        ref = _masked(7, models, y, mask, cfg)
        eager_calls = eigh.calls - calls
    calls = eigh.calls
    got = _masked(7, models, y, mask, cfg)
    assert eigh.calls - calls == eager_calls  # the warm-up's are undone
    (route,) = _routes("masked")
    assert route.runs_eigh is runs_eigh and not route.graphed and route.graphs == {}
    _assert_equal(got, ref)


# -- SMC²'s online step ---------------------------------------------------------

def _sampler(kind, inner, m=M, n=N, chain=2):
    return tsmc.SMC2(SPECS[kind], prior_from_spec(BENCH_PRIOR, device="cpu"),
                     tsmc.SMCConfig(n_particles=n, n_theta=m, chain=chain,
                                    inner=_config(inner)))


@pytest.mark.parametrize("entry", ["run", "step"])
@pytest.mark.parametrize("kind,inner", [
    ("dsl_ucsv", "systematic"), ("dsl_ucsv", "stratified_ess"), ("dsl_ucsv", "apf"),
    ("ucsv", "residual"), ("ucsv", "metropolis"), ("dsl_ucsv", "residual")])
def test_online_route_equals_eager(routed, kind, inner, entry):
    """Eleven online steps with rejuvenations through the online route (one
    flag read and one replay a step; the rejuvenations' masked filters on
    their own routes), driven by ``run`` or by ``step``, bitwise the eager
    loop: state and every StepInfo."""
    sampler, y = _sampler(kind, inner), _series(12)

    def drive(gen):
        if entry == "run":
            return sampler.run(gen, y)
        state, infos = sampler.init(gen, y), []
        for _ in range(len(y) - 1):
            state, info = sampler.step(gen, state, y)
            infos.append(info)
        return state, tsmc.StepInfo(*(torch.stack(list(f)) for f in zip(*infos)))

    got = drive(torch.Generator().manual_seed(0))
    (online,) = _routes("online")
    assert online.replays == online.buffers.reads == len(y) - 1
    assert _routes("masked"), "the rejuvenations' masked filters take their routes"
    with tsmc.disable_graphs():
        ref = drive(torch.Generator().manual_seed(0))
    assert ref[1].rejuvenated.any(), "the series should degenerate the θ-cloud"
    for k in ("theta", "log_omega", "particles", "log_w", "log_z", "ess", "acc_ratio"):
        assert torch.equal(getattr(got[0], k), getattr(ref[0], k)), k
    assert got[0].t == ref[0].t
    _assert_equal(tuple(got[1]), tuple(ref[1]))


def test_online_guided_route_equals_eager(routed):
    """SMC² on the AR(1) DSL model with the guided proposal inside its
    online step and its rejuvenations, through the routes, bitwise eager."""
    sampler = tsmc.SMC2(AR1, prior_from_spec(LG_PRIOR, device="cpu"),
                        tsmc.SMCConfig(n_particles=N, n_theta=M, chain=2,
                                       inner=tsmc.PFConfig(proposal=GUIDED)))
    y = _lg_series(16)
    got = sampler.run(torch.Generator().manual_seed(2), y)
    assert _routes("online")[0].replays == len(y) - 1
    with tsmc.disable_graphs():
        ref = sampler.run(torch.Generator().manual_seed(2), y)
    _assert_equal((got[0].theta, got[0].particles, got[0].log_z, tuple(got[1])),
                  (ref[0].theta, ref[0].particles, ref[0].log_z, tuple(ref[1])))


# -- the store routes -------------------------------------------------------------

def _quantiles(state):
    return weighted_quantile(state.particles[:, 0], torch.exp(state.log_weights),
                                  (0.25, 0.5, 0.75))


@pytest.mark.parametrize("entry", ["filter_sequence", "filter_sequence_guided",
                                   "forward_clouds", "posterior_smoothed_paths"])
def test_store_routes_equal_eager(routed, entry):
    """``filter_sequence`` (with a quantile summary; the DSL UC-SV, or the
    AR(1) with the guided proposal), ``forward_clouds`` and the posterior
    mixture's forward bank on DSL models through their store routes,
    bitwise the eager loops; ⌊(T−1)/S⌋ + (T−1) mod S replays."""
    ucsv, ar1 = UCSV4(torch.tensor([0.2, 3.0, -1.0, -1.0])), AR1(torch.tensor([0.5, 0.9, 0.8]))
    y = _series(2 * S + 5)
    theta = torch.tensor(np.random.default_rng(1).normal([0.2, 3.0, -1.0, -1.0], 0.05, (12, 4)),
                         dtype=torch.float32)
    log_omega = torch.tensor(np.random.default_rng(2).normal(size=12), dtype=torch.float32)
    calls = {
        "filter_sequence": lambda gen: tsmc.filter_sequence(gen, ucsv, 96, y,
                                                            summarize=_quantiles),
        "filter_sequence_guided": lambda gen: tsmc.filter_sequence(
            gen, ar1, 96, _lg_series(len(y)), proposal=GUIDED, summarize=_quantiles),
        "forward_clouds": lambda gen: tsmc.forward_clouds(gen, ucsv, 96, y),
        "posterior_smoothed_paths": lambda gen: (tsmc.posterior_smoothed_paths(
            gen, UCSV4, theta, log_omega, y, 96, n_theta=3, n_paths=4),)}
    got = calls[entry](torch.Generator().manual_seed(6))
    (route,) = _routes("stored")
    assert route.replays == (len(y) - 1) // S + (len(y) - 1) % S
    with tsmc.disable_graphs():
        ref = calls[entry](torch.Generator().manual_seed(6))
    _assert_equal(got, ref)


# -- conditional SMC and particle Gibbs -------------------------------------------

@pytest.mark.parametrize("method", ["bs", "as"])
def test_csmc_route_on_a_dsl_model_equals_eager(routed, method):
    """``csmc_sweep`` on the DSL AR(1) (the plain propagate route inside the
    captured sweep), twice — the second from a new generator, reference
    path and θ on the cached route — bitwise the eager sweeps."""
    y = _lg_series(T)
    refs = [torch.zeros((T, 1)), torch.from_numpy(
        np.random.default_rng(3).normal(size=(T, 1)).astype(np.float32))]
    thetas = [torch.tensor([0.5, 0.9, 0.8]), torch.tensor([0.45, 0.8, 0.7])]

    def call(i):
        out = tsmc.csmc_sweep(torch.Generator().manual_seed(10 + i), AR1(thetas[i]), N, y,
                              refs[i], method)
        return (out.path, tuple(out.cloud), out.ancestors, out.log_z)

    got = (call(0), call(1))
    (route,) = _routes("csmc")
    assert route.replays == 2
    with tsmc.disable_graphs():
        ref = (call(0), call(1))
    _assert_equal(got, ref)


@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("method", ["bs", "as"])
def test_pg_route_on_a_dsl_model_equals_eager(routed, method, chains):
    """Particle Gibbs on the DSL AR(1), one chain (``particle_gibbs``, its
    ``model_fn`` building the DSL model in the sweep) or three as one bank
    (the spec itself as ``bank_fn``: ``ModelSpec.__call__`` inside the
    graph), three sweeps through the PG route, bitwise the eager loop: θ
    chain, acceptances, final and collected paths, the generator's state."""
    prior = prior_from_spec(LG_PRIOR, device="cpu")
    cfg = tsmc.PGConfig(n_particles=N, sweeps=3, chain=2, method=method, collect_paths=True)
    y = _lg_series(T)

    def run():
        gen = torch.Generator().manual_seed(8)
        if chains == 1:
            res = tsmc.particle_gibbs(gen, AR1, prior, y, cfg)
        else:
            res = _particle_gibbs_bank(gen, AR1, prior, y, cfg, prior.sample(gen, (chains,)))
        return tuple(res), gen.get_state()

    got = run()
    (pg,) = _routes("pg")
    assert pg.replays == 3 and not _routes("csmc")
    with tsmc.disable_graphs():
        ref = run()
    _assert_equal(got, ref)


# -- the DSL's fields, built without a copy from the host ----------------------------

def _today(v, like):
    """The field conversion before fills: ``torch.as_tensor``."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


@pytest.mark.parametrize("value", ["int", "float", "bool", "zero_d", "zero_d_f64", "tensor",
                                   "tensor_i64", "numpy"])
def test_fields_equal_todays(value):
    """``_as_like`` (the DSL's field conversion) and ``_tensor_fields``
    give fields equal to ``torch.as_tensor``'s by ``torch.equal``, dtype
    and shape, for numbers, 0-d tensors, tensors and arrays; a tensor of
    θ's dtype and device is returned as the same object (its expanded
    field a view of it)."""
    like = torch.tensor([[0.5, 0.9, 0.8]] * 4)
    v = {"int": 2, "float": 0.1, "bool": True, "zero_d": torch.tensor(0.3),
         "zero_d_f64": torch.tensor(0.3, dtype=torch.float64),
         "tensor": torch.tensor([0.1, 0.2, 0.3, 0.4]), "tensor_i64": torch.arange(4),
         "numpy": np.array([0.1, 0.2, 0.3, 0.4])}[value]
    got, ref = _as_like(v, like), _today(v, like)
    assert got.dtype == ref.dtype == like.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)
    if isinstance(v, torch.Tensor) and v.dtype == like.dtype:
        assert got is v
    dist = _tensor_fields(tsmc.Normal(v, 1.0), (4,), like, trailing=True)
    assert dist.loc.shape == dist.scale.shape == (4, 1)
    assert torch.equal(dist.loc, ref.expand(4)[..., None])
    assert torch.equal(dist.scale, torch.ones(4, 1))
    if isinstance(v, torch.Tensor) and v.dtype == like.dtype and v.dim():
        assert dist.loc.data_ptr() == v.data_ptr()


@pytest.mark.parametrize("defaults,overrides", [
    ({"x0": 0.0}, {}), ({"x0": 1}, {"x0": 2.5}), ({"x0": 0.0, "s": -1.0}, {"s": torch.tensor(0.7)}),
    ({"x0": torch.tensor(0.25)}, {}), ({"x0": torch.tensor(0.25, dtype=torch.float64)}, {})])
@pytest.mark.parametrize("rows", [None, 5])
def test_spec_defaults_equal_todays(defaults, overrides, rows):
    """``ModelSpec.__call__``'s θ with the defaults' tail (built from fills
    for numbers) equals ``torch.as_tensor``'s stack by ``torch.equal``,
    dtype and shape, on a (k,) θ and an (M, k) θ-cloud."""
    spec = tsmc.ssm_model("probe", params=("a",), defaults=defaults,
                          init=lambda p: dict(x=tsmc.Normal(0.0, 1.0)),
                          transition=lambda p, prev: dict(x=tsmc.Normal(prev["x"], 1.0)),
                          observe=lambda p, s: tsmc.Normal(s["x"], 1.0))
    theta = torch.full((1,) if rows is None else (rows, 1), 0.5)
    got = spec(theta, **overrides).theta
    values = dict(defaults, **overrides)
    tail = torch.stack([_today(values[n], theta) for n in defaults])
    ref = torch.cat([theta, tail.expand(theta.shape[:-1] + tail.shape)], dim=-1)
    assert got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got, ref)


# -- in distribution, against the JAX package --------------------------------------

# JAX SMC² at M=64, N=256, T=40, chain=2 over 8 seeds, and the seed spread
# of the two packages' posterior means there (tests/test_torch_smc2.py)
SMALL_SD = np.array([0.05668, 0.486902, 0.141507, 0.137714])


def test_dsl_online_route_posterior_matches_jax(routed):
    """The routed DSL UC-SV SMC² (the online step and the rejuvenations'
    masked filters on the DSL's plain propagate route) against the JAX
    package's SMC² on the same ``ssm_model`` program: the mean over 8 seeds
    of the posterior means agree within 5·sd·√(2/8), sd the two packages'
    seed spread at this configuration (``SMALL_SD``). (JAX is imported
    here: the card's tests run this file without it.)"""
    import jax
    import jax.numpy as jnp

    import sequential_monte_carlo_tpu as jsmc

    m, n, t, chain, seeds = 64, 256, 40, 2, 8
    y = _series(t).numpy()
    cfg = dict(n_particles=n, n_theta=m, chain=chain, ess_threshold=0.5)
    kinds = {"uniform": jsmc.Uniform, "normal": jsmc.Normal}
    prior = jsmc.product_distribution([kinds[k](jnp.asarray(a, jnp.float32),
                                                jnp.asarray(b, jnp.float32))
                                       for k, a, b in BENCH_PRIOR])
    jax_sampler = jsmc.SMC2(jsmc.ssm_model("ucsv4", **_ucsv4_program(jnp, jsmc.Normal)), prior,
                            jsmc.SMCConfig(**cfg))
    port = tsmc.SMC2(UCSV4, prior_from_spec(BENCH_PRIOR, device="cpu"), tsmc.SMCConfig(**cfg))
    jax_means, port_means = [], []
    for s in range(seeds):
        st_j, _ = jax_sampler.run(jax.random.key(s), jnp.asarray(y))
        jax_means.append(np.asarray(jsmc.expected_parameters(st_j)))
        st, infos = port.run(torch.Generator().manual_seed(s), torch.from_numpy(y))
        assert math.isfinite(st.ess.item()) and infos.ess.shape == (t - 1,)
        port_means.append(tsmc.expected_parameters(st).numpy())
    assert _routes("online")[0].replays == seeds * (t - 1)
    diff = np.mean(port_means, 0) - np.mean(jax_means, 0)
    tol = 5 * SMALL_SD * math.sqrt(2 / seeds)
    assert np.all(np.abs(diff) <= tol), (diff, tol)


# -- on the card: each replayed loop against its disable_graphs() twin ----------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the graphs are captured and replayed on the card")
    graphs.clear_graphs()
    yield torch.device("cuda")
    graphs.clear_graphs()


def _counted(fn):
    from sequential_monte_carlo_tpu_torch.kernels import _build

    before = _build.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, [a - b for a, b in zip(_build.launch_counts(), before)]


def _twins(fn):
    """``fn()`` graphed, then under ``disable_graphs()``, each with its
    launch counts."""
    got = _counted(fn)
    with tsmc.disable_graphs():
        ref = _counted(fn)
    return got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("kind,inner", [
    ("dsl_ucsv", "systematic"), ("dsl_ucsv", "stratified_ess"), ("dsl_ucsv", "apf"),
    ("lg", "guided"), ("lg", "residual"), ("lg", "metropolis"), ("ucsv", "residual")])
def test_masked_replays_equal_eager_on_the_card(cuda, kind, inner):
    """The masked filter at 512×1024 over 40 observations, replayed from
    graphs on each new route, equals its eager twin bit for bit: particles,
    log-weights, log Z, the generator's state and the launch counts."""
    models, y = _bank(kind, 512, 0, cuda), _y(kind, 40).to(cuda)
    mask, cfg = torch.ones(40), _config(inner)
    got, ref = _twins(lambda: _masked(0, models, y, mask, cfg, cuda))
    (route,) = _routes("masked")
    assert route.graphed and route.replays == 39 // S + 39 % S
    _assert_equal(got[0], ref[0])
    assert got[1] == ref[1]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,inner", [("dsl_ucsv", "systematic"), ("dsl_ucsv", "apf"),
                                        ("ucsv", "metropolis")])
def test_online_replays_equal_eager_on_the_card(cuda, kind, inner):
    """SMC² 512×1024 over 30 observations on the DSL UC-SV (or the native
    model at metropolis) replayed from the online route: state, StepInfo,
    the generator's state and the launch counts equal the eager run's."""
    sampler = tsmc.SMC2(SPECS[kind], prior_from_spec(BENCH_PRIOR, device="cuda"),
                        tsmc.SMCConfig(n_particles=1024, n_theta=512, chain=2,
                                       inner=_config(inner)))
    y = _series(30).to(cuda)

    def run():
        gen = torch.Generator(device=cuda).manual_seed(0)
        state, infos = sampler.run(gen, y)
        return (state.theta, state.particles, state.log_w, state.log_z, state.ess,
                tuple(infos), gen.get_state())

    got, ref = _twins(run)
    (online,) = _routes("online")
    assert online.graphed and online.replays == len(y) - 1
    _assert_equal(got[0], ref[0])
    assert got[1] == ref[1]


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["csmc_bs", "csmc_as", "pg_1", "pg_8", "filter_sequence"])
def test_dsl_sweeps_and_stores_replay_equal_eager_on_the_card(cuda, entry):
    """CSMC sweeps (both methods), PG (one chain and 8 as a bank) on the DSL
    AR(1) and ``filter_sequence`` on the DSL UC-SV, replayed, equal their
    eager twins bit for bit with the same launch counts."""
    y = _lg_series(60).to(cuda)
    ref_path = torch.zeros((60, 1), device=cuda)
    prior = prior_from_spec(LG_PRIOR, device="cuda")
    cfg = tsmc.PGConfig(n_particles=128, sweeps=10, chain=2, collect_paths=True)

    def run():
        gen = torch.Generator(device=cuda).manual_seed(3)
        if entry.startswith("csmc"):
            out = tsmc.csmc_sweep(gen, AR1(torch.tensor([0.5, 0.9, 0.8], device=cuda)), 256, y,
                                  ref_path, entry[-2:])
            res = (out.path, tuple(out.cloud), out.ancestors)
        elif entry == "pg_1":
            res = tuple(tsmc.particle_gibbs(gen, AR1, prior, y, cfg))
        elif entry == "pg_8":
            res = tuple(_particle_gibbs_bank(gen, AR1, prior, y, cfg, prior.sample(gen, (8,))))
        else:
            res = tsmc.filter_sequence(gen, UCSV4(torch.tensor([0.2, 3.0, -1.0, -1.0],
                                                               device=cuda)),
                                       8192, _series(60).to(cuda), summarize=_quantiles)
        return res, gen.get_state()

    got, ref = _twins(run)
    assert all(r.graphed for r in graphs._cache.values())
    _assert_equal(got[0], ref[0])
    assert got[1] == ref[1]


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["transition", "observe", "proposal"])
def test_host_read_in_a_dsl_function_or_proposal_raises(cuda, where):
    """A DSL function that reads the host (``float(p["a"])``) or a proposal
    step that branches on a tensor cannot be captured: ``CaptureError``
    naming it, at capture; no route is kept and nothing runs eagerly in its
    place; ``disable_graphs()`` runs it."""
    def transition_reads_host(p, prev):
        return dict(x=tsmc.Normal(float(p["a"][0]) * prev["x"], torch.sqrt(p["q"])))

    def observe_reads_host(p, s):
        return tsmc.Normal(s["x"], torch.sqrt(p["r"]) if p["r"][0] > 0 else 1.0)

    def step_reads_host(mm, xp):
        return tsmc.Product(tsmc.Normal(mm.theta[..., 0:1] * xp, torch.sqrt(mm.theta[..., 1:2])
                                        * mm.theta[..., 2].max().item()))

    spec = tsmc.ssm_model(
        "ar1_host", params=("a", "q", "r"), init=lambda p: dict(x=tsmc.Normal(0.0, 1.0)),
        transition=(transition_reads_host if where == "transition" else
                    lambda p, prev: dict(x=tsmc.Normal(p["a"] * prev["x"], torch.sqrt(p["q"])))),
        observe=(observe_reads_host if where == "observe" else
                 lambda p, s: tsmc.Normal(s["x"], torch.sqrt(p["r"]))))
    cfg = (tsmc.PFConfig(proposal=tsmc.Proposal(lambda mm: mm.initial_distribution(),
                                                 step_reads_host))
           if where == "proposal" else tsmc.PFConfig())
    models, y = spec(_theta("ar1", 64, 0).to(cuda)), _lg_series(20).to(cuda)
    name = {"transition": "transition_reads_host", "observe": "observe_reads_host",
            "proposal": "step_reads_host"}[where]
    with pytest.raises(graphs.CaptureError, match=name):
        _masked(0, models, y, torch.ones(20), cfg, cuda)
    assert not graphs._cache
    torch.cuda.synchronize()
    with tsmc.disable_graphs():
        out, _ = _masked(0, models, y, torch.ones(20), cfg, cuda)
    assert torch.isfinite(out[2]).all()


@pytest.mark.gpu
def test_eigh_rule_on_the_card(cuda):
    """The eigh rule on the card: the LG dx = 2 bank with an ``MvNormal``
    proposal is admitted by ``captures`` but captured not at all (the
    warm-up ran eigh): its route runs its bodies eagerly, bitwise the
    ``disable_graphs()`` twin with the same launch counts; the bootstrap on
    the same bank replays graphs."""
    models = _lg2(512, 0, cuda)
    proposal = tsmc.Proposal(
        initial=lambda mm: mm.initial_distribution(),
        step=lambda mm, xp: tsmc.MvNormal((mm.A @ xp[..., None])[..., 0], 2.0 * mm.Q))
    y, mask = _lg_series(40).to(cuda), torch.ones(40)
    for cfg, graphed in ((tsmc.PFConfig(proposal=proposal), False), (tsmc.PFConfig(), True)):
        graphs.clear_graphs()
        assert tbf.captures(cfg, None, cuda)
        got, ref = _twins(lambda: _masked(0, models, y, mask, cfg, cuda))
        (route,) = _routes("masked")
        assert route.graphed is graphed and route.runs_eigh is not graphed
        _assert_equal(got[0], ref[0])
        assert got[1] == ref[1]


@pytest.mark.gpu
def test_replayed_residual_one_row_is_the_same_run_to_run(cuda):
    """``filter_sequence`` at one row (residual's remainder cdf of one row,
    scanned through ``_row_cumsum``) at N = 65,536, replayed three times,
    gives the same bits each time and its eager twin's."""
    model = tsmc.ucsv_model(torch.tensor([0.2, 3.0, -1.0, -1.0], device=cuda))
    y, cfg = _series(30).to(cuda), tsmc.PFConfig("residual")
    runs = [_counted(lambda: tsmc.filter_sequence(torch.Generator(device=cuda).manual_seed(1),
                                                  model, 65536, y, cfg))[0] for _ in range(3)]
    with tsmc.disable_graphs():
        runs.append(tsmc.filter_sequence(torch.Generator(device=cuda).manual_seed(1), model,
                                         65536, y, cfg))
    for run in runs[1:]:
        _assert_equal(tuple(run[0]) + (run[1], run[2]), tuple(runs[0][0]) + (runs[0][1],
                                                                               runs[0][2]))
