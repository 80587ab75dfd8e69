"""The benchmark's readers of the port's spans and route counters
(``port_bench/metrics/``: ``rejuvenation_share_pct``, ``idle_us_per_filter``,
``idle_us_per_online_step``, ``graph_replays_per_inner_step``,
``graph_capture_s``, and ``_spans.py``'s idle put down to spans) on
hand-made traces and counters, and on the host events of a real CPU run of
SMC² with its aten ops standing in for the device's work.
"""
from __future__ import annotations

import collections
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sequential_monte_carlo_tpu_torch as tsmc
from port_bench.harness import catalog
from port_bench.harness.trace import Trace
from port_bench.metrics import _spans
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf
from sequential_monte_carlo_tpu_torch.ops import graphs

torch.set_num_threads(1)

SPAN_READERS = ("rejuvenation_share_pct", "idle_us_per_filter", "idle_us_per_online_step")
COUNTER_READERS = ("graph_replays_per_inner_step", "graph_capture_s")
US = 1000  # ns


def _read(name, ctx):
    return catalog.load_module("metrics", name).read(ctx)


def _made_trace(spans=True):
    """A 1100 µs span: one posterior's spans (two online steps, the first
    rejuvenating through one filter) and five device operations."""
    device = [("k", 0, 50), ("k", 160, 200), ("k", 310, 340), ("k", 900, 1000),
              ("k", 1050, 1100)]
    host = [("smc.run", 0, 900), ("smc.online_step", 100, 300), ("smc.rejuvenate", 120, 250),
            ("smc.filter", 130, 240), ("smc.filter_init", 130, 150), ("smc.route", 150, 160),
            ("smc.online_step", 300, 350), ("cudaGraphLaunch", 100, 110)]
    if not spans:
        host = [op for op in host if not op[0].startswith("smc.")]
    return Trace([(n, s * US, e * US) for n, s, e in device],
                 [(n, s * US, e * US) for n, s, e in host], (0, 1100 * US))


@pytest.fixture
def program_counts(monkeypatch):
    """A stand-in for the program's graphs module with its counters."""
    module = types.ModuleType(_spans.GRAPHS)
    module.graph_stats = collections.Counter(
        captures=2, warmup_s=0.5, capture_s=0.25, instantiate_s=0.125, replays=30,
        replayed_steps=120, evictions=0)
    monkeypatch.setitem(sys.modules, _spans.GRAPHS, module)
    return module


def test_idle_is_put_down_to_the_innermost_span():
    tr = _made_trace()
    by_span = _spans.idle_by_span(tr)
    expect = {"smc.run": 600, "smc.online_step": 70 + 20, "smc.rejuvenate": 20,
              "smc.filter_init": 20, "smc.route": 10, "smc.filter": 40, _spans.OUTSIDE: 50}
    assert by_span == pytest.approx({k: v * 1e-6 for k, v in expect.items()}, abs=1e-12)
    assert sum(by_span.values()) == pytest.approx(tr.window_s - tr.busy_s(), abs=1e-12)
    assert tr.idle_gaps() == [("cudaGraphLaunch", 110e-6), ("host, no call", 110e-6),
                              ("host, no call", 560e-6), ("host, no call", 50e-6)]


def test_the_span_readers_on_a_made_trace():
    ctx = SimpleNamespace(trace=_made_trace())
    assert _read("rejuvenation_share_pct", ctx) == pytest.approx(100 * 130 / 900)
    assert _read("idle_us_per_filter", ctx) == pytest.approx(70.0)  # 20 + 10 + 40
    assert _read("idle_us_per_online_step", ctx) == pytest.approx((70 + 20) / 2)


def test_the_counter_readers_read_the_program_s_graph_stats(program_counts):
    ctx = SimpleNamespace(trace=None)
    assert _read("graph_replays_per_inner_step", ctx) == 0.25
    assert _read("graph_capture_s", ctx) == 0.375
    program_counts.graph_stats.clear()  # a run that replayed and captured nothing
    assert _read("graph_replays_per_inner_step", ctx) is None
    assert _read("graph_capture_s", ctx) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_span_reader_gives_nothing_without_a_trace_or_spans(name):
    assert _read(name, SimpleNamespace(trace=None)) is None
    assert _read(name, SimpleNamespace(trace=_made_trace(spans=False))) is None


@pytest.mark.parametrize("name", COUNTER_READERS)
@pytest.mark.parametrize("program", ["control", "without_counters"])
def test_a_counter_reader_gives_nothing_without_the_program_s_counters(monkeypatch, name,
                                                                       program):
    """The control never loads the program; an older program has no
    ``graph_stats``."""
    if program == "control":
        monkeypatch.delitem(sys.modules, _spans.GRAPHS, raising=False)
    else:
        monkeypatch.setitem(sys.modules, _spans.GRAPHS, types.ModuleType(_spans.GRAPHS))
    assert _read(name, SimpleNamespace(trace=_made_trace())) is None


def test_the_new_metrics_are_listed_for_their_cells():
    bench = catalog.benchmark()
    smc2 = {m["name"] for m in catalog.metrics_for(bench, "smc2_ucsv_512x8192", True)}
    bank = {m["name"] for m in catalog.metrics_for(bench, "filters_lg_64x65536", True)}
    assert set(SPAN_READERS + COUNTER_READERS) <= smc2
    assert {"idle_us_per_filter", *COUNTER_READERS} <= bank
    assert not {"rejuvenation_share_pct", "idle_us_per_online_step"} & bank


def test_the_readers_on_a_cpu_run_of_smc2(monkeypatch):
    """A routed 16 × 64 SMC² run under the CPU profiler: its spans as host
    events, its aten ops as the device's work. The idle put down to spans
    sums to the span's idle, and each reader reads a number."""
    captures = tbf.captures
    monkeypatch.setattr(tbf, "captures", lambda config, active_n, device: captures(
        config, active_n, torch.device("cuda")))
    graphs.clear_graphs()
    rng = np.random.default_rng(1998)
    y = 3.0 + np.cumsum(rng.normal(0, 0.3, 241)) + rng.normal(0, 0.5, 241)
    y = torch.from_numpy(y.astype(np.float32)[:12])
    prior = prior_from_spec([("uniform", 0.0, 1.0), ("normal", 3.0, 2.0), ("uniform", 0.0, 2.0),
                             ("uniform", 0.0, 2.0)], device="cpu")
    sampler = tsmc.SMC2(tsmc.ucsv_model, prior, tsmc.SMCConfig(n_particles=64, n_theta=16,
                                                                chain=2))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, infos = sampler.run(torch.Generator().manual_seed(0), y)
    finally:
        graphs.clear_graphs()
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]
    (run,) = [op for op in events if op[0] == "smc.run"]
    tr = Trace([op for op in events if op[0].startswith("aten::")], events, run[1:])
    by_span = _spans.idle_by_span(tr)
    assert abs(sum(by_span.values()) - (tr.window_s - tr.busy_s())) < 1e-6
    assert _spans.OUTSIDE not in by_span and "smc.capture" in by_span
    ctx = SimpleNamespace(trace=tr)
    assert 0 < _read("rejuvenation_share_pct", ctx) < 100
    assert _read("idle_us_per_filter", ctx) > 0
    assert _read("idle_us_per_online_step", ctx) > 0
    assert _spans.idle_under(tr, "smc.filter")[1] == 2 * int(infos.rejuvenated.sum())
