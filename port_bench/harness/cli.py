"""One run of one cell: set-up, the window, the traced calls, the check,
the metrics, and the result's line."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from . import catalog, device, imports, trace, window


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for every number with a limit:
    correct where each is finite and at most its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in checks.values())
    return correct, checks


def make_entry(name: str, seed: int, dev: str, t_start: float,
               bench_dir: Path = catalog.BENCH_DIR, overrides=None, program: str = "program"):
    """(BENCHMARK.json, the cell, its entry after set-up and the warm-up,
    setup_s): the imports, the CUDA context, the program's objects and the
    inputs, one warm-up call; each part's seconds on standard error."""
    bench = catalog.benchmark(bench_dir.parent)
    cell = catalog.cell(name, bench, bench_dir)
    parts = {}
    mark = t_start

    def lap(part):
        nonlocal mark
        now = time.perf_counter()
        parts[part] = now - mark
        mark = now

    import torch

    lap("start_s")
    if dev != "cpu":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        lap("cuda_context_s")
    smc = None
    if program == "program":
        import sequential_monte_carlo_tpu_torch as smc

        lap("import_program_s")
    entry_mod = catalog.load_module("entries", cell["entry"], bench_dir)
    entry = entry_mod.Entry(torch, smc, cell, seed, dev, program, overrides)
    window.sync(torch, dev)
    lap("inputs_s")
    entry.after(-1, entry.call(-1), keep=False)  # the warm-up: every shape this cell uses
    window.sync(torch, dev)
    gc.collect()  # set-up's garbage, and its objects kept out of the window's collections
    gc.freeze()
    lap("warmup_s")
    setup_s = time.perf_counter() - t_start
    say("setup: " + " ".join(f"{k}={v:.4f}" for k, v in parts.items()) + f" setup_s={setup_s:.4f}")
    return bench, cell, entry, setup_s


def run_cell(name: str, seed: int, seconds: float, traced: bool, dev: str, t_start: float,
             bench_dir: Path = catalog.BENCH_DIR, overrides=None, program: str = "program",
             trace_calls=None, limits=None) -> dict:
    """The result of one run of cell ``name``; ``dev`` "cuda" or "cpu" (the
    CPU tests: no trace). ``program`` "control" puts the reference in the
    precision below in the program's place. ``overrides`` (sizes) and
    ``limits`` replace the workload's (the CPU tests' small sizes)."""
    bench, cell, entry, setup_s = make_entry(name, seed, dev, t_start, bench_dir, overrides,
                                             program)
    torch = entry.torch
    win = window.run(torch, entry, seconds, dev)
    say(f"window: calls={len(win['calls'])} window_s={win['window_s']:.4f}")
    tr, traced_calls = None, []
    if traced:
        count = int(trace_calls or cell["params"]["trace_calls"])

        def calls():
            out = []
            for i in range(win["next"], win["next"] + count):
                t0 = time.perf_counter()
                res = entry.call(i)
                window.sync(torch, dev)
                out.append((i, time.perf_counter() - t0, entry.after(i, res, keep=False)))
            return out

        traced_calls, tr = trace.traced(torch, calls)
    info = device.describe(torch, int(cell["chips"]), dev)
    entry.release()
    checked = entry.check()
    correct, checks = judge(checked["numbers"], limits or cell["limits"])
    ctx = SimpleNamespace(cell=cell, setup_s=setup_s, window=win, trace=tr,
                          traced_calls=traced_calls, shape=entry.shape)
    metrics = {}
    for spec in catalog.metrics_for(bench, name, traced):
        value = catalog.load_module("metrics", spec["name"], bench_dir).read(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    if tr is not None:
        info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    result = {"correct": correct, "attempted": len(win["calls"]), "failed": checked["failed"],
              "metrics": metrics, "device": info}
    if tr is not None:
        result["breakdown"] = breakdown(tr)
    result["info"] = {**checked["info"], **{k: v for k, v in checked["numbers"].items()
                                             if k not in checks}}
    result["checks"] = checks
    result["correct"] = correct and checked["failed"] == 0
    return result


def breakdown(tr) -> dict:
    """The ten device operations that took most time, by name, and the ten
    host activities that the longest idle time fell under."""
    ops, gaps = {}, {}
    for n, s, e in tr.in_span():
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
    for label, sec in tr.idle_gaps():
        total, count = gaps.get(label, (0.0, 0))
        gaps[label] = (total + sec, count + 1)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[f"{label} x{count}", sec] for label, (sec, count) in idle]}


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = catalog.benchmark()
    chips = int(catalog.cell(args.workload, bench)["chips"])
    import torch

    why = device.missing(torch, chips)
    if why:
        say(f"no result: {why}")
        return 2
    return emit(run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         t_start))


def emit(result: dict) -> int:
    """Print the result: its extra readings and each compared number beside
    its limit on standard error, then its line, last on standard output.
    Where JAX or the JAX package is loaded by now (by the program, a metric
    reader or anything they import), name it and print no result: 3."""
    found = imports.forbidden_loaded()
    if found:
        say(f"no result: JAX or the JAX package is loaded: {found}")
        return 3
    for k, v in result["info"].items():
        say(f"info {k}={v}")
    for k, v in result["checks"].items():
        say(f"check {k}={v['value']!r} limit={v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
