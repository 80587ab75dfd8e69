"""The port's compiled loops (``ops/graphs.py``) beyond the masked filter's
one-step replays: SMC²'s online step (its collector captured inside it),
the masked filter's S steps to a launch, and ``filter_sequence`` and the
forward bank on their store routes.

On the CPU nothing is captured: with ``batched_filter.captures`` answering
as it would on the card (the ``routed`` fixture), every loop runs through
its route — the buffers, the loads, the flag reads, the stores and the
replays grouped as the graphs would launch them — with each step body run
eagerly, and is held bit for bit against the eager loop. The replays
themselves are held against their ``disable_graphs()`` twins on the card
(the ``gpu`` cases at the end), which skip here. Only the posterior test
imports JAX, inside it, so that the card runs this file without JAX:

    python -m pytest --noconftest tests/test_torch_online_graphs.py -m gpu
"""
import contextlib
import math

import numpy as np
import pytest
import torch

import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.analysis import weighted_quantile
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf
from sequential_monte_carlo_tpu_torch.ops import graphs

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

S = graphs.STEPS_PER_GRAPH
BENCH_PRIOR = [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
               ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)]
INNER = {"systematic": ("systematic", 1.0), "stratified_ess": ("stratified", 0.5),
         "apf": ("systematic", 1.0, None, "apf")}
STATE_FIELDS = ("theta", "log_omega", "particles", "log_w", "log_z", "ess", "acc_ratio")


def _series(t, seed=1998):
    """bench.py's synthetic inflation-like series, first t points."""
    rng = np.random.default_rng(seed)
    y = 3.0 + np.cumsum(rng.normal(0, 0.3, 241)) + rng.normal(0, 0.5, 241)
    return torch.from_numpy(y.astype(np.float32)[:t])


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


def _sampler(inner, m=16, n=64, chain=2, **kw):
    return tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cpu"),
                     tsmc.SMCConfig(n_particles=n, n_theta=m, chain=chain,
                                    inner=tsmc.PFConfig(*INNER[inner]), **kw))


def _assert_states_equal(a, b):
    for k in STATE_FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert (a.t, a.active_n, a.exchange_pending) == (b.t, b.active_n, b.exchange_pending)


def _assert_infos_equal(a, b):
    for k in a._fields:
        x, z = getattr(a, k), getattr(b, k)
        assert x.shape == z.shape and x.device == z.device and torch.equal(x, z), k


def _routes(kind: str):
    return [r for key, r in graphs._cache.items() if key[0] == kind]


@pytest.mark.parametrize("driver", ["run", "step"])
@pytest.mark.parametrize("inner", sorted(INNER))
def test_online_body_equals_eager_step(routed, inner, driver):
    """Eleven online steps with at least one rejuvenation through the online
    route (one flag read and one replay a step, the rejuvenations between
    them), driven by ``run`` or by ``step``, bitwise the eager loop: state
    and every StepInfo."""
    sampler, y = _sampler(inner), _series(12)

    def drive(gen):
        if driver == "run":
            return sampler.run(gen, y)
        state, infos = sampler.init(gen, y), []
        for _ in range(len(y) - 1):
            state, info = sampler.step(gen, state, y)
            infos.append(info)
        return state, tsmc.StepInfo(*(torch.stack(list(f)) for f in zip(*infos)))

    got = drive(torch.Generator().manual_seed(0))
    online = _routes("online")
    assert len(online) == 1 and online[0].replays == len(y) - 1
    assert online[0].buffers.reads == len(y) - 1
    with tsmc.disable_graphs():
        ref = drive(torch.Generator().manual_seed(0))
    assert ref[1].rejuvenated.any(), "the series should degenerate the θ-cloud"
    _assert_states_equal(got[0], ref[0])
    _assert_infos_equal(got[1], ref[1])


@pytest.mark.parametrize("live", [0, 1, S - 1, S, S + 1, 2 * S + 3])
def test_multi_step_graph_equals_one_step_bodies(routed, live):
    """The masked filter over L live times replays ⌊L/S⌋ launches of the
    S-step graph and L mod S one-step launches, bitwise the eager loop, for
    L = 0, 1, S − 1, S, S + 1 and 2S + 3 (the live times with holes)."""
    m, n, t = 6, 64, 2 * S + 8
    theta = torch.tensor(np.random.default_rng(0).uniform(0.3, 0.9, (m, 3)), dtype=torch.float32)
    models, y = tsmc.lg_model(theta), _series(t)
    mask = torch.zeros(t)
    mask[0] = 1.0
    mask[torch.tensor(np.sort(np.random.default_rng(live).choice(
        np.arange(1, t), live, replace=False)), dtype=torch.long)] = 1.0
    cfg = tsmc.PFConfig("stratified", 0.5)
    got = tbf.batched_log_likelihood_masked(torch.Generator().manual_seed(3), models, n, m, y,
                                            mask, cfg)
    routes = _routes("masked")
    assert sum(r.replays for r in routes) == live // S + live % S
    with tsmc.disable_graphs():
        ref = tbf.batched_log_likelihood_masked(torch.Generator().manual_seed(3), models, n, m,
                                                y, mask, cfg)
    for name, a, b in zip(("particles", "log_w", "log_z"), got, ref):
        assert torch.equal(a, b), name


def _summaries():
    def quantiles(state):
        return weighted_quantile(state.particles[:, 0], torch.exp(state.log_weights),
                                 (0.25, 0.5, 0.75))

    def tree(state):
        w = torch.exp(state.log_weights)
        return {"q": weighted_quantile(state.particles[:, 1], w, [0.1, 0.9]),
                "mean": (torch.sum(w * state.particles[:, 0]), torch.max(w))}

    return {"none": None, "quantiles": quantiles, "tree": tree}


@pytest.mark.parametrize("summary", ["none", "quantiles", "tree"])
@pytest.mark.parametrize("inner", ["systematic", "stratified_ess"])
def test_filter_sequence_store_body_equals_eager(routed, inner, summary):
    """``filter_sequence`` through its store route (log-mean, ESS and the
    summaries written at each live time) bitwise its eager loop: the final
    state, log Z and every per-step series."""
    model = tsmc.ucsv_model(torch.tensor([0.2, 3.0, -1.0, -1.0]))
    y, summarize = _series(2 * S + 5), _summaries()[summary]
    cfg = tsmc.PFConfig(*INNER[inner])
    got = tsmc.filter_sequence(torch.Generator().manual_seed(5), model, 128, y, cfg,
                               summarize=summarize)
    (route,) = _routes("stored")
    assert route.replays == (len(y) - 1) // S + (len(y) - 1) % S
    with tsmc.disable_graphs():
        ref = tsmc.filter_sequence(torch.Generator().manual_seed(5), model, 128, y, cfg,
                                   summarize=summarize)
    assert torch.equal(got[0].particles, ref[0].particles)
    assert torch.equal(got[0].log_weights, ref[0].log_weights)
    assert torch.equal(got[1], ref[1])
    for a, b in zip(graphs._leaves(got[2]), graphs._leaves(ref[2]), strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
    assert sorted(got[2]) == sorted(ref[2])


@pytest.mark.parametrize("entry", ["forward_clouds", "posterior_smoothed_paths",
                                   "smoothed_marginals"])
def test_forward_bank_store_body_equals_eager(routed, entry):
    """The forward bank through its store route (each cloud into
    (T, m, dx, N), each set of log-weights into (T, m, N)) bitwise its eager
    loop, through each entry point that runs it."""
    model = tsmc.ucsv_model(torch.tensor([0.2, 3.0, -1.0, -1.0]))
    y = _series(S + 3)
    theta = torch.tensor(np.random.default_rng(1).normal([0.2, 3.0, -1.0, -1.0], 0.05, (12, 4)),
                         dtype=torch.float32)
    log_omega = torch.tensor(np.random.default_rng(2).normal(size=12), dtype=torch.float32)
    calls = {"forward_clouds": lambda gen: tsmc.forward_clouds(gen, model, 96, y),
             "smoothed_marginals": lambda gen: tuple(tsmc.smoothed_marginals(gen, model, 96, y)),
             "posterior_smoothed_paths": lambda gen: (tsmc.posterior_smoothed_paths(
                 gen, tsmc.ucsv_model, theta, log_omega, y, 96, n_theta=3, n_paths=4),)}
    got = calls[entry](torch.Generator().manual_seed(6))
    (route,) = _routes("stored")
    assert route.replays == (len(y) - 1) // S + (len(y) - 1) % S
    with tsmc.disable_graphs():
        ref = calls[entry](torch.Generator().manual_seed(6))
    for a, b in zip(got, ref, strict=True):
        assert a.shape == b.shape and a.stride() == b.stride() and torch.equal(a, b)


@pytest.mark.parametrize("inner", ["systematic", "apf"])
def test_step_returns_a_state_that_owns_its_arrays(routed, inner):
    """A state returned by ``step`` on the online route owns its arrays: a
    later step (its replay writes the route's buffers) leaves it as it was,
    and none of its tensors shares storage with the buffers."""
    sampler, y = _sampler(inner), _series(8)
    gen = torch.Generator().manual_seed(2)
    state = sampler.init(gen, y)
    state1, info1 = sampler.step(gen, state, y)
    kept = {k: getattr(state1, k).clone() for k in STATE_FIELDS}
    kept_info = [x.clone() for x in info1]
    state2, _ = sampler.step(gen, state1, y)
    state3, _ = sampler.step(gen, state2, y)
    for k, v in kept.items():
        assert torch.equal(getattr(state1, k), v), k
    for a, b in zip(info1, kept_info):
        assert torch.equal(a, b)
    (route,) = _routes("online")
    buffers = route.buffers
    ptrs = {x.untyped_storage().data_ptr() for x in (*buffers.clouds, *buffers.log_w,
                                                     buffers.log_omega, buffers.log_z,
                                                     buffers.ess)}
    for st in (state1, state2, state3):
        assert not ptrs & {getattr(st, k).untyped_storage().data_ptr() for k in STATE_FIELDS}


def test_run_segmented_with_a_collector_equals_eager(routed):
    """``run_segmented`` with a collector split by ``max_steps`` and resumed:
    the collector runs inside the route's step on the state it just wrote,
    its outputs stored on the route at each t (one returns a buffer's view
    itself), bitwise the eager loop's, infos and series."""
    from sequential_monte_carlo_tpu_torch.analysis import state_quantiles, state_variance

    sampler, y = _sampler("systematic"), _series(14)

    def collect(state):
        return {"xq": state_quantiles(state, [0.25, 0.5, 0.75]), "var": state_variance(state),
                "log_z": state.log_z, "yt": torch.take(y, state.t - 1)}

    def drive(gen):
        state, (infos1, s1) = sampler.run_segmented(gen, y, collect_fn=collect, max_steps=6)
        state, (infos2, s2) = sampler.run_segmented(gen, y, collect_fn=collect, state=state)
        return state, infos1, infos2, s1, s2

    got = drive(torch.Generator().manual_seed(0))
    (route,) = _routes("online")
    assert route.buffers.collect is not None and route.replays == len(y) - 1
    with tsmc.disable_graphs():
        ref = drive(torch.Generator().manual_seed(0))
    _assert_states_equal(got[0], ref[0])
    _assert_infos_equal(got[1], ref[1])
    _assert_infos_equal(got[2], ref[2])
    for a, b in zip(graphs._leaves(got[3]) + graphs._leaves(got[4]),
                    graphs._leaves(ref[3]) + graphs._leaves(ref[4]), strict=True):
        assert torch.equal(a, b)
    assert got[3]["log_z"].shape == (6, 16) and not torch.equal(got[3]["log_z"][0],
                                                                got[3]["log_z"][-1])
    assert torch.equal(got[4]["yt"], y[7:])


def _pending_collector(state):
    """The exchange phase's collector: the posterior mean, t and the
    exchange's pending flag, which a captured collector sees as device
    tensors."""
    return tsmc.expected_parameters(state), state.t, state.exchange_pending


def test_captured_collector_across_an_exchange_grow(routed):
    """``run_segmented`` with a collector in "grow" mode, split by
    ``max_steps`` and resumed: the collector inside the online route at
    each N, its series bitwise the eager loop's across each doubling onto a
    new route; t and the pending flag as int64 and bool tensors on both
    paths."""
    y = _series(16)
    grow = _sampler("systematic", m=16, n=32, acc_threshold=1.1, exchange_max_n=64)

    def drive(gen):
        state, (i1, s1) = grow.run_segmented(gen, y, collect_fn=_pending_collector,
                                             max_steps=7)
        state, (i2, s2) = grow.run_segmented(gen, y, collect_fn=_pending_collector, state=state)
        return state, i1, i2, s1, s2

    got = drive(torch.Generator().manual_seed(1))
    routes = _routes("online")
    assert all(r.buffers.collect is not None for r in routes)
    assert {r.buffers.clouds[0].shape[-1] for r in routes} == {32, 64, 128}
    with tsmc.disable_graphs():
        ref = drive(torch.Generator().manual_seed(1))
    _assert_states_equal(got[0], ref[0])
    for a, b in zip(got[1:3], ref[1:3]):
        _assert_infos_equal(a, b)
    for a, b in zip(graphs._leaves(got[3:]), graphs._leaves(ref[3:]), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ts = torch.cat([got[3][1], got[4][1]])
    assert ts.dtype == torch.int64 and torch.equal(ts, torch.arange(2, len(y) + 1))
    assert got[3][2].dtype == torch.bool and bool(torch.cat([got[3][2], got[4][2]]).any())


def test_collector_closure_made_again_keeps_its_route(routed):
    """A collector made anew by the same ``def`` over the same objects (the
    inflation example's, made a run) replays the route captured for the
    first; one over another series gets a route of its own."""
    sampler, y = _sampler("systematic"), _series(8)

    def collector(series):
        def collect(state):
            return torch.take(series, state.t - 1) + state.log_z
        return collect

    first = sampler.run(torch.Generator().manual_seed(0), y, collect_fn=collector(y))
    sampler.run(torch.Generator().manual_seed(0), y, collect_fn=collector(y))
    assert len(_routes("online")) == 1
    again = sampler.run(torch.Generator().manual_seed(0), y, collect_fn=collector(y))
    assert torch.equal(first[1][1], again[1][1])
    sampler.run(torch.Generator().manual_seed(0), y, collect_fn=collector(y.clone()))
    assert len(_routes("online")) == 2


def test_collector_that_is_not_a_tensor_raises(routed):
    """A collector leaf that is not a tensor on the state's device cannot be
    stored by a replayed step: ``CaptureError`` naming the collector, which
    never runs eagerly in its place."""
    sampler, y = _sampler("systematic"), _series(6)

    def as_number(state):
        return float(state.ess)

    with pytest.raises(graphs.CaptureError, match="as_number"):
        sampler.run(torch.Generator().manual_seed(0), y, collect_fn=as_number)
    assert not _routes("online")


def test_exchange_grow_doubles_onto_a_new_route(routed):
    """The exchange step in "grow" mode: each doubling refilters eagerly
    (its masked filters replayed) and the steps after it run on the online
    route at the new N, bitwise the eager loop; under "full" padding the
    arrays keep their padded N and each live count steps on an online route
    of its own (``tests/test_torch_elastic_graphs.py`` holds those runs
    bitwise)."""
    y = _series(16)
    grow = _sampler("systematic", m=16, n=32, acc_threshold=1.1, exchange_max_n=64)
    got = grow.run(torch.Generator().manual_seed(1), y)
    shapes = {r.buffers.clouds[0].shape[-1] for r in _routes("online")}
    with tsmc.disable_graphs():
        ref = grow.run(torch.Generator().manual_seed(1), y)
    assert ref[0].active_n == 128 and shapes == {32, 64, 128}
    _assert_states_equal(got[0], ref[0])
    _assert_infos_equal(got[1], ref[1])
    graphs.clear_graphs()
    full = _sampler("systematic", m=16, n=32, acc_threshold=1.1, exchange_max_n=64,
                    elastic_pad="full")
    full.run(torch.Generator().manual_seed(1), y)
    assert {r.buffers.clouds[0].shape[-1] for r in _routes("online")} == {128}
    assert sorted(r.buffers.active_n for r in _routes("online")) == [32, 64, 128]


def test_summarize_that_is_not_a_tensor_raises(routed):
    """A summary leaf that is not a tensor on the filter's device cannot be
    stored by a replayed step: ``CaptureError`` naming the summarize."""
    model = tsmc.ucsv_model(torch.tensor([0.2, 3.0, -1.0, -1.0]))

    def as_number(state):
        return float(state.log_weights.max())

    with pytest.raises(graphs.CaptureError, match="as_number"):
        tsmc.filter_sequence(torch.Generator().manual_seed(0), model, 64, _series(6),
                             summarize=as_number)
    assert not graphs._cache


# JAX SMC² at M=64, N=256, T=40, chain=2 over 8 seeds, and the seed spread
# of the two packages' posterior means there (tests/test_torch_smc2.py)
SMALL_SD = np.array([0.05668, 0.486902, 0.141507, 0.137714])


def test_online_route_posterior_matches_jax(routed):
    """Posterior tier, as ``tests/test_torch_smc2.py`` holds the eager
    sampler: the mean over 8 seeds of the route-driven run's posterior mean
    against the same for the JAX package, at M=64, N=256, T=40, chain=2,
    within 5·sd·√(2/8). (JAX is imported here: the card's tests run this
    file without it.)"""
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
    jax_sampler = jsmc.SMC2(jsmc.ucsv_model, prior, jsmc.SMCConfig(**cfg))
    port = tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cpu"),
                     tsmc.SMCConfig(**cfg))
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


# -- on the card: each replayed loop against its disable_graphs() twin --------

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


@pytest.mark.gpu
@pytest.mark.parametrize("inner", sorted(INNER))
def test_online_replays_equal_eager_on_the_card(cuda, inner):
    """SMC² UC-SV 512×1024 over 30 observations replayed from the online
    route: state, StepInfo, the generator's state and the launch counts
    equal the eager run's; one replay and one flag read a step."""
    sampler = tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cuda"),
                        tsmc.SMCConfig(n_particles=1024, n_theta=512, chain=2,
                                       inner=tsmc.PFConfig(*INNER[inner])))
    y = _series(30).to(cuda)
    runs = {}
    for mode in ("graphed", "eager"):
        gen = torch.Generator(device=cuda).manual_seed(0)
        with (tsmc.disable_graphs() if mode == "eager" else contextlib.nullcontext()):
            (state, infos), counts = _counted(lambda: sampler.run(gen, y))
        runs[mode] = (state, infos, counts, gen.get_state())
    (online,) = _routes("online")
    assert online.replays == online.buffers.reads == len(y) - 1
    _assert_states_equal(runs["graphed"][0], runs["eager"][0])
    _assert_infos_equal(runs["graphed"][1], runs["eager"][1])
    assert runs["graphed"][2] == runs["eager"][2]
    assert torch.equal(runs["graphed"][3], runs["eager"][3])


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["filter_sequence", "forward_clouds", "posterior_paths"])
def test_store_replays_equal_eager_on_the_card(cuda, entry):
    """``filter_sequence`` with a quantile summary, ``forward_clouds`` at
    1×8192 and the posterior mixture's 8×8192 forward bank, replayed, equal
    their eager runs bit for bit with the same launch counts; ⌊(T−1)/S⌋ +
    (T−1) mod S replays."""
    model = tsmc.ucsv_model(torch.tensor([0.2, 3.0, -1.0, -1.0], device=cuda))
    y = _series(60).to(cuda)
    theta = torch.tensor(np.random.default_rng(1).normal([0.2, 3.0, -1.0, -1.0], 0.05,
                                                         (64, 4)), dtype=torch.float32,
                         device=cuda)
    log_omega = torch.zeros(64, device=cuda)
    calls = {
        "filter_sequence": lambda gen: tsmc.filter_sequence(
            gen, model, 8192, y, summarize=_summaries()["quantiles"]),
        "forward_clouds": lambda gen: tsmc.forward_clouds(gen, model, 8192, y),
        "posterior_paths": lambda gen: tsmc.posterior_smoothed_paths(
            gen, tsmc.ucsv_model, theta, log_omega, y, 8192, n_theta=8, n_paths=16)}
    runs = {}
    for mode in ("graphed", "eager"):
        with (tsmc.disable_graphs() if mode == "eager" else contextlib.nullcontext()):
            runs[mode] = _counted(lambda: calls[entry](torch.Generator(device=cuda).manual_seed(4)))
    (route,) = _routes("stored")
    assert route.replays == (len(y) - 1) // S + (len(y) - 1) % S
    for a, b in zip(graphs._leaves(runs["graphed"][0]), graphs._leaves(runs["eager"][0]),
                    strict=True):
        assert torch.equal(a, b)
    assert runs["graphed"][1] == runs["eager"][1]


@pytest.mark.gpu
def test_collector_replays_equal_eager_on_the_card(cuda):
    """The inflation example's UC run (512×1024, chain 3, its collector
    captured into the online step) over 60 observations of its series:
    state, StepInfo, series and launch counts equal the eager run's; one
    replay and one flag read a step."""
    from sequential_monte_carlo_tpu_torch.examples import inflation as ex

    y = _series(60).to(cuda)
    sampler = tsmc.SMC2(tsmc.uc_model, ex.uc_prior("cuda"),
                        tsmc.SMCConfig(n_particles=1024, n_theta=512, chain=3,
                                       ess_threshold=0.5))
    runs = {}
    for mode in ("graphed", "eager"):
        gen = torch.Generator(device=cuda).manual_seed(0)
        with (tsmc.disable_graphs() if mode == "eager" else contextlib.nullcontext()):
            runs[mode] = _counted(lambda: sampler.run_segmented(
                gen, y, segment_size=16, collect_fn=ex.online_collector(y)))
    (online,) = _routes("online")
    assert online.graphed and online.replays == online.buffers.reads == len(y) - 1
    (sg, (ig, series_g)), cg = runs["graphed"]
    (se, (ie, series_e)), ce = runs["eager"]
    _assert_states_equal(sg, se)
    _assert_infos_equal(ig, ie)
    assert cg == ce and sorted(series_g) == ["cq", "var", "xq"]
    for k in series_g:
        assert torch.equal(series_g[k], series_e[k]), k


@pytest.mark.gpu
def test_collector_reading_the_host_raises_at_capture(cuda):
    """A collector that reads the host (Python indexing with the device t,
    which calls ``.item()``) cannot be captured into the replayed step:
    ``CaptureError`` naming it, at capture, never run eagerly in its place;
    ``disable_graphs()`` runs it."""
    sampler = tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cuda"),
                        tsmc.SMCConfig(n_particles=256, n_theta=64, chain=2))
    y = _series(12).to(cuda)

    def indexes_on_host(state):
        return y[state.t - 1] + state.log_z

    with pytest.raises(graphs.CaptureError, match="indexes_on_host"):
        sampler.run(torch.Generator(device=cuda).manual_seed(0), y, collect_fn=indexes_on_host)
    assert not _routes("online")
    with tsmc.disable_graphs():
        _, (infos, series) = sampler.run(torch.Generator(device=cuda).manual_seed(0), y,
                                         collect_fn=indexes_on_host)
    assert series.shape == (11, 64)


@pytest.mark.gpu
def test_summarize_reading_the_host_raises_at_capture(cuda):
    """A ``summarize`` that reads the host (``.item()``) cannot be captured
    into the replayed step: ``CaptureError`` naming it, at capture; no route
    is kept, and ``disable_graphs()`` runs it."""
    model = tsmc.ucsv_model(torch.tensor([0.2, 3.0, -1.0, -1.0], device=cuda))
    y = _series(20).to(cuda)

    def reads_host(state):
        return torch.full((), state.log_weights.max().item(), device=cuda)

    with pytest.raises(graphs.CaptureError, match="reads_host"):
        tsmc.filter_sequence(torch.Generator(device=cuda).manual_seed(0), model, 1024, y,
                             summarize=reads_host)
    assert not graphs._cache
    with tsmc.disable_graphs():
        _, _, series = tsmc.filter_sequence(torch.Generator(device=cuda).manual_seed(0), model,
                                            1024, y, summarize=reads_host)
    assert series["summary"].shape == (20,)
