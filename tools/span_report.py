#!/usr/bin/env python3
"""One benchmark cell run as ``port_bench/run.py --trace 1`` runs it, with
what its result's line does not hold, on one GPU:

    python3 tools/span_report.py --workload <cell> --seed <n> --seconds <s> [--out <json>]

It snapshots the program's ``ops/graphs.py::graph_stats`` after set-up,
after the window and around the traced calls (the harness reads them only
at the end), and prints on standard error:

- ``idle_by_span``: the device's idle time in the traced span put down to
  the innermost program span (``smc.*``) the host was in, or to "outside
  the program", with their sum against the span's idle (window − busy);
- ``replays``: ``graph_stats["replays"]`` over the traced calls against
  the trace's ``cudaGraphLaunch`` calls, and over the window's calls per
  inner step;
- ``setup``: the captures, their warm-up, capture and instantiate seconds
  in set-up, and the captures and evictions of the window;
- ``tracing_cost``: the traced calls' mean wall against the window's mean
  call wall (the profiler's and the spans' cost when on);
- ``device_spans``: device events named like a program span (a span the
  profiler mirrored onto the device's timeline; none expected);
- ``idle_by_span_and_call``: the idle gaps by the innermost span and the
  innermost runtime or aten call (``Trace.idle_gaps``'s label) the host
  was in at each gap's middle, the twelve largest.

Then the result's line, as ``run.py`` prints it, with these numbers under
``"span_report"``, last on standard output (and in ``--out``). A program
without ``graph_stats`` (an older commit) reads as counting nothing.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):  # as port_bench/run.py
    os.environ[var] = "1"
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "port_bench", ".cache", "triton")
sys.path.insert(0, ROOT)

from port_bench.harness import cli, trace, window  # noqa: E402
from port_bench.metrics import _spans  # noqa: E402


def stats() -> collections.Counter:
    return collections.Counter(_spans.graph_stats() or {})


def idle_by_span_and_call(tr) -> dict:
    """{"<innermost span at a gap's middle> | <its idle_gaps label>": idle
    seconds}: which runtime or aten call the host was in, within each span."""
    pieces, out, j = _spans.idle_pieces(tr), collections.Counter(), 0
    for (s, e), (label, sec) in zip(_spans.idle_segments(tr), tr.idle_gaps()):
        mid = (s + e) // 2
        while pieces[j][1] <= mid:  # the piece that holds the gap's middle
            j += 1
        names = pieces[j][2]
        out[f"{names[-1] if names else _spans.OUTSIDE} | {label}"] += sec
    return dict(out.most_common(12))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    snaps, kept = {}, {}
    run_window, run_traced = window.run, trace.traced

    def windowed(torch, entry, seconds, dev):
        snaps["setup"] = stats()
        kept["window"] = run_window(torch, entry, seconds, dev)
        snaps["window"] = stats()
        return kept["window"]

    def traced(torch, fn):
        def counted():  # the last attempt's snapshots are the kept trace's
            snaps["traced_before"] = stats()
            out = fn()
            snaps["traced_after"] = stats()
            return out

        out, tr = run_traced(torch, counted)
        kept["calls"], kept["trace"] = out, tr
        return out, tr

    window.run, trace.traced = windowed, traced
    try:
        result = cli.run_cell(args.workload, args.seed, args.seconds, True, "cuda", T_START)
    finally:
        window.run, trace.traced = run_window, run_traced
    tr, win = kept["trace"], kept["window"]
    by_span = _spans.idle_by_span(tr)
    idle_s = tr.window_s - tr.busy_s()
    traced_replays = snaps["traced_after"]["replays"] - snaps["traced_before"]["replays"]
    window_steps = sum(rec["inner_steps"] for _, _, rec in win["calls"])
    window_walls = [wall for _, wall, _ in win["calls"]]
    traced_walls = [wall for _, wall, _ in kept["calls"]]
    setup, after = snaps["setup"], snaps["window"]
    report = {
        "idle_by_span": by_span,
        "idle_by_span_sum_s": sum(by_span.values()),
        "idle_s": idle_s,
        "replays_traced": traced_replays,
        "graph_launches_traced": tr.host_calls("cudaGraphLaunch"),
        "replays_per_inner_step_window": (after["replays"] - setup["replays"]) / window_steps,
        "setup": {k: setup[k] for k in ("captures", "warmup_s", "capture_s", "instantiate_s",
                                        "replays", "replayed_steps", "evictions")},
        "window_captures": after["captures"] - setup["captures"],
        "window_evictions": after["evictions"] - setup["evictions"],
        "traced_call_wall_mean_s": sum(traced_walls) / len(traced_walls),
        "window_call_wall_mean_s": sum(window_walls) / len(window_walls),
        "device_spans": sum(1 for n, _, _ in tr.device_ops if n.startswith(_spans.PREFIX)),
        "span_counts": collections.Counter(n for n, _, _ in _spans.spans(tr)),
        "idle_by_span_and_call": idle_by_span_and_call(tr),
    }
    report["tracing_cost"] = (report["traced_call_wall_mean_s"]
                              / report["window_call_wall_mean_s"] - 1.0)
    say = cli.say
    say("idle_by_span: " + " ".join(f"{k!r}={v:.6f}" for k, v in by_span.items()))
    say(f"idle_by_span: sum={report['idle_by_span_sum_s']:.9f} s against the span's idle"
        f" {idle_s:.9f} s")
    say(f"replays: graph_stats over the traced calls {traced_replays}, cudaGraphLaunch"
        f" {report['graph_launches_traced']}; over the window"
        f" {report['replays_per_inner_step_window']:.6f} an inner step")
    say(f"setup: {report['setup']}; window captures {report['window_captures']}, evictions"
        f" {report['window_evictions']}")
    say(f"tracing_cost: traced call {report['traced_call_wall_mean_s']:.6f} s against the"
        f" window's {report['window_call_wall_mean_s']:.6f} s"
        f" ({100 * report['tracing_cost']:+.2f}%)")
    say(f"device_spans: {report['device_spans']}; span counts {dict(report['span_counts'])}")
    say("idle_by_span_and_call: " + "; ".join(
        f"{k}={v:.6f}" for k, v in report["idle_by_span_and_call"].items()))
    result["span_report"] = report
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps({"workload": args.workload, "seed": args.seed, **result}) + "\n")
    return cli.emit(result)


if __name__ == "__main__":
    sys.exit(main())
