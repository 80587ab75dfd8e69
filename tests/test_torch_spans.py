"""The port's spans and route counters: ``utils/profiling.py::named_scope``
(a shared no-op without a profiler; with one, a host range that is not a
user annotation, so the profiler mirrors nothing onto the device), the
spans SMC² and the masked filter open at their phase boundaries, and
``ops/graphs.py::graph_stats``.

On the CPU nothing is captured: with ``batched_filter.captures`` answering
as on the card (the ``routed`` fixture), the loops run through their routes
and count their launches as the graphs would launch them.
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf
from sequential_monte_carlo_tpu_torch.ops import graphs
from sequential_monte_carlo_tpu_torch.utils.profiling import named_scope

torch.set_num_threads(1)

S = graphs.STEPS_PER_GRAPH
BENCH_PRIOR = [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
               ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)]
CHAIN = 2


def _series(t, seed=1998):
    """bench.py's synthetic inflation-like series, first t points."""
    rng = np.random.default_rng(seed)
    y = 3.0 + np.cumsum(rng.normal(0, 0.3, 241)) + rng.normal(0, 0.5, 241)
    return torch.from_numpy(y.astype(np.float32)[:t])


@pytest.fixture
def routed(monkeypatch):
    """``captures`` as on the card: the loops take their routes on the CPU."""
    captures = tbf.captures
    monkeypatch.setattr(tbf, "captures", lambda config, active_n, device: captures(
        config, active_n, torch.device("cuda")))
    graphs.clear_graphs()
    yield
    graphs.clear_graphs()


def _sampler(m=16, n=64):
    return tsmc.SMC2(tsmc.ucsv_model, prior_from_spec(BENCH_PRIOR, device="cpu"),
                     tsmc.SMCConfig(n_particles=n, n_theta=m, chain=CHAIN))


def _spans(prof) -> list:
    """[(name, start, end)] of the program's spans, in order of start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("smc.")), key=lambda op: (op[1], -op[2]))


def _parents(spans) -> list:
    """Each span's innermost enclosing span's name (None at the top)."""
    out = []
    for i, (_, s, e) in enumerate(spans):
        around = [p for p in spans[:i] if p[1] <= s and e <= p[2]]
        out.append(max(around, key=lambda p: (p[1], -p[2]))[0] if around else None)
    return out


def _masked_filter(live: int):
    m, n, t = 6, 64, 2 * S + 8
    theta = torch.tensor(np.random.default_rng(0).uniform(0.3, 0.9, (m, 3)), dtype=torch.float32)
    mask = torch.zeros(t)
    mask[0] = 1.0
    mask[torch.tensor(np.sort(np.random.default_rng(live).choice(
        np.arange(1, t), live, replace=False)), dtype=torch.long)] = 1.0
    return lambda: tbf.batched_log_likelihood_masked(
        torch.Generator().manual_seed(3), tsmc.lg_model(theta), n, m, _series(t), mask,
        tsmc.PFConfig("stratified", 0.5))


def test_named_scope_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    a, b = named_scope("smc.run"), named_scope("smc.filter")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    with named_scope("smc.after"):  # the profiler has stopped
        torch.ones(4).sum()
    assert not _spans(prof)


def test_named_scope_records_a_host_range_that_is_no_user_annotation():
    """Under a profiler the span is a host event around its ops, at the
    function scope: the profiler mirrors user annotations (and only those)
    onto the device's timeline, where they would read as device work."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with named_scope("smc.test"):
            torch.ones(64).cumsum(0)
    events = list(prof.profiler.kineto_results.events())
    (span,) = [e for e in events if e.name() == "smc.test"]
    assert not span.is_user_annotation()
    assert any(e.name() == "aten::cumsum" and span.start_ns() <= e.start_ns()
               and e.end_ns() <= span.end_ns() for e in events)


@pytest.mark.parametrize("path", ["eager", "routed"])
def test_smc2_run_opens_one_span_a_phase(request, path):
    """A 16 × 64 ``SMC2.run`` over 12 observations: one ``smc.run``, one
    ``smc.init``, T − 1 ``smc.online_step``, one ``smc.rejuvenate`` a
    rejuvenation and ``chain`` ``smc.filter`` (each with its
    ``smc.filter_init``) in each, every span in its parent. Routed, a route
    lookup for the online route and for each filter, and no span inside a
    capture: the spans do not grow with the replays."""
    if path == "routed":
        request.getfixturevalue("routed")
    sampler, y = _sampler(), _series(12)
    before = collections.Counter(graphs.graph_stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, infos = sampler.run(torch.Generator().manual_seed(0), y)
    spans = _spans(prof)
    counts = collections.Counter(n for n, _, _ in spans)
    rejuvenations = int(infos.rejuvenated.sum())
    assert rejuvenations >= 1, "the series should degenerate the θ-cloud"
    filters = CHAIN * rejuvenations
    expect = {"smc.run": 1, "smc.init": 1, "smc.online_step": len(y) - 1,
              "smc.rejuvenate": rejuvenations, "smc.filter": filters,
              "smc.filter_init": filters}
    if path == "routed":
        expect.update({"smc.route": 1 + filters, "smc.capture": 2})
    assert dict(counts) == expect
    parent = {"smc.run": None, "smc.init": "smc.run", "smc.online_step": "smc.run",
              "smc.rejuvenate": "smc.online_step", "smc.filter": "smc.rejuvenate",
              "smc.filter_init": "smc.filter", "smc.capture": "smc.route"}
    for (name, _, _), up in zip(spans, _parents(spans)):
        if name == "smc.route":
            assert up in ("smc.run", "smc.filter"), up
        else:
            assert up == parent[name], (name, up)
    replays = graphs.graph_stats["replays"] - before["replays"]
    if path == "routed":  # far more launches than spans, none of them spanned
        assert replays == len(y) - 1 + sum(
            CHAIN * ((t - 1) // S + (t - 1) % S)
            for t in (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist())
    else:
        assert replays == 0


@pytest.mark.parametrize("live", [0, 1, S - 1, S, S + 1, 2 * S + 3])
def test_graph_stats_count_a_masked_filter_s_launches(routed, live):
    """A masked filter over L live steps launches ⌊L/S⌋ + L mod S graphs
    for its L steps; its first call captures its route, a second at the same
    shapes captures nothing and launches as many again."""
    run = _masked_filter(live)
    for captures in (int(live > 0), 0):
        before = collections.Counter(graphs.graph_stats)
        run()
        got = collections.Counter(graphs.graph_stats)
        got.subtract(before)
        assert got["replays"] == live // S + live % S
        assert got["replayed_steps"] == live
        assert got["captures"] == captures
        assert got["warmup_s"] > 0 if captures else got["warmup_s"] == 0


def test_the_spans_of_a_filter_do_not_depend_on_its_live_steps(routed):
    """Inside ``smc.filter``: its init and its route's lookup, whatever the
    live steps and launches (no span a replay)."""
    for live in (S - 1, 2 * S + 5):
        _masked_filter(live)()  # capture first
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _masked_filter(live)()
        assert [n for n, _, _ in _spans(prof)] == ["smc.filter", "smc.filter_init", "smc.route"]


def test_a_second_run_at_the_same_shapes_adds_no_captures(routed):
    sampler, y = _sampler(), _series(12)
    sampler.run(torch.Generator().manual_seed(0), y)
    first = collections.Counter(graphs.graph_stats)
    sampler.run(torch.Generator().manual_seed(1), y)
    for part in ("captures", "warmup_s", "capture_s", "instantiate_s", "evictions"):
        assert graphs.graph_stats[part] == first[part], part
    assert graphs.graph_stats["replays"] > first["replays"]


def test_graph_stats_count_the_lru_s_evictions_and_outlive_clear_graphs(routed, monkeypatch):
    monkeypatch.setattr(graphs, "CACHE_SIZE", 1)
    before = collections.Counter(graphs.graph_stats)
    _masked_filter(S)()
    _masked_filter(S)()  # the same route: nothing evicted
    assert graphs.graph_stats["evictions"] == before["evictions"]
    _sampler().run(torch.Generator().manual_seed(0), _series(12))  # online + masked routes
    evicted = graphs.graph_stats["evictions"] - before["evictions"]
    assert evicted >= 2
    graphs.clear_graphs()
    assert graphs.graph_stats["evictions"] - before["evictions"] == evicted
