#!/usr/bin/env python3
"""Where a replayed masked-filter step's wall goes, on one GPU.

    python3 tools/replay_trace.py [--out replay_trace.json]

On 512 UC-SV filters at chip_smoke.JAX_MEAN, N=1024, over the first L
observations of bench.py's series (K1 + K2-UC-SV, a captured route of
``ops/graphs.py``), it reports:

- ``filter``: the wall of one ``batched_log_likelihood`` at L = 40 and 240
  live steps (best of five warm runs), and the line through them: the
  fixed cost of a filter (init, copy-in, result) and the wall per step;
- ``pieces``: the same filter's parts timed alone, each ending in a
  synchronize: the init, the kernel parameters, the copy-in of a route's
  buffers and the result's copies;
- ``host``: the host's cost of the Python around a replay (the generator's
  state moved in and out, the launch counters) over many calls;
- ``steps_per_graph``: for S consecutive steps captured in one graph
  (through ``graphs.StepBuffers``, as the route captures one), the capture's
  seconds and, over 240 steps, the wall, the host's issue (the device held
  behind a sleep kernel) and the device's run per step, and the graph
  pool's memory;
- ``trace``: torch.profiler (host and device) over one filter at L = 40:
  the host's ops and CUDA runtime calls by self time, the kernels' device
  time, the gaps between the device's kernels and the host's time between
  graph launches, and which runtime calls a host read (``.item()``, an
  event's synchronize, a device synchronize) leaves in the trace. The
  Chrome trace goes beside ``--out``.

Prints one JSON line per part, each with the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

STEPS = (40, 240)
GRAPH_STEPS = (1, 2, 4, 8, 16, 24, 48)  # each divides 240


def _wall(torch, fn, repeats: int = 5) -> float:
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _behind_sleep(torch, fn, wall: float) -> tuple:
    """(host seconds to issue fn, device seconds to run it) with the device
    held behind a sleep kernel while the host issues."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(max(cs.SLEEP_CYCLES, int(3 * wall * cs.sm_clock_hz())))
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    issue = time.perf_counter() - t0
    started = start.query()
    end.synchronize()
    if started:
        raise AssertionError(f"issuing took {issue:.4f} s, past the sleep")
    return issue, start.elapsed_time(end) / 1e3


def _filter_parts(torch, smc, out: dict, models, ys, gen) -> None:
    from sequential_monte_carlo_tpu_torch.ops import batched_filter as bf
    from sequential_monte_carlo_tpu_torch.ops import graphs

    walls = {}
    for steps in STEPS:
        y = ys[:steps + 1]
        smc.batched_log_likelihood(gen, models, cs.DT_N, cs.DT_M, y)  # capture
        walls[steps] = _wall(torch, lambda: smc.batched_log_likelihood(gen, models, cs.DT_N,
                                                                       cs.DT_M, y))
    lo, hi = STEPS
    per_step = (walls[hi] - walls[lo]) / (hi - lo)
    out["filter"] = {"walls_s": {str(k): round(v, 6) for k, v in walls.items()},
                     "ms_per_step": round(1e3 * per_step, 5),
                     "fixed_ms": round(1e3 * (walls[lo] - lo * per_step), 4),
                     "ms_per_step_at_40_whole_call": round(1e3 * walls[lo] / lo, 5)}

    y = ys[:lo + 1]
    cfg = smc.PFConfig()
    init = bf.batched_pf_init(gen, models, cs.DT_N, cs.DT_M, y[0], cfg)
    params = bf.kernel_params(models, cfg)
    live = torch.arange(1, lo + 1)
    buffers = graphs.StepBuffers(models, params, bf.as_cloud(init.particles), init.log_weights,
                                 y, 256)
    pieces = {
        "init": lambda: bf.batched_pf_init(gen, models, cs.DT_N, cs.DT_M, y[0], cfg),
        "kernel_params": lambda: bf.kernel_params(models, cfg),
        "live_times": lambda: torch.nonzero(torch.ones(lo + 1)[1:] > 0).flatten() + 1,
        "copy_in": lambda: buffers.load(models, params, init, y, live),
        "result": lambda: buffers.result(0),
    }
    out["pieces_ms"] = {k: round(1e3 * _wall(torch, fn, 20), 4) for k, fn in pieces.items()}


def _host_costs(torch, out: dict, gen) -> None:
    from sequential_monte_carlo_tpu_torch.kernels._build import (
        add_launch_counts,
        launch_counts,
        set_launch_counts,
    )

    other = torch.Generator(device="cuda")
    before = launch_counts()
    delta = [0 if not hasattr(c, "keys") else c.__class__() for c in before]
    n = 2000

    def per_call(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return round(1e6 * (time.perf_counter() - t0) / n, 3)

    out["host_us"] = {
        "generator_get_state": per_call(gen.get_state),
        "generator_set_state": per_call(lambda: other.set_state(gen.get_state())),
        "add_launch_counts": per_call(lambda: add_launch_counts(delta)),
    }
    set_launch_counts(before)


def _steps_per_graph(torch, smc, out: dict, models, ys, gen) -> None:
    from sequential_monte_carlo_tpu_torch.ops import batched_filter as bf
    from sequential_monte_carlo_tpu_torch.ops import graphs

    y = ys[:241]
    cfg = smc.PFConfig()
    init = bf.batched_pf_init(gen, models, cs.DT_N, cs.DT_M, y[0], cfg)
    params = bf.kernel_params(models, cfg)
    live = torch.arange(1, 241)
    rows = []
    for s in GRAPH_STEPS:
        graphs.clear_graphs()
        pool = torch.cuda.graph_pool_handle()
        route_gen = torch.Generator(device="cuda")
        buffers = graphs.StepBuffers(models, params, bf.as_cloud(init.particles),
                                     init.log_weights, y, 256)
        buffers.load(models, params, init, y, live)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            buffers.step(route_gen, cfg, 0)  # the warm-up
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        captured = []
        for start in ((0,) if s % 2 == 0 else (0, 1)):
            g = torch.cuda.CUDAGraph()
            g.register_generator_state(route_gen)
            with torch.cuda.graph(g, pool=pool, capture_error_mode="global"):
                k = start
                for _ in range(s):
                    buffers.step(route_gen, cfg, k)
                    k = 1 - k
            captured.append(g)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        pool_mb = cs._graph_pool_mb(torch)  # this capture's pool: clear_graphs freed the last

        def run(s=s, captured=captured, buffers=buffers, route_gen=route_gen):
            buffers.load(models, params, init, y, live)
            route_gen.set_state(gen.get_state())
            k = 0
            for _ in range(240 // s):
                captured[k].replay()
                k = (k + s) % 2
            gen.set_state(route_gen.get_state())

        run()
        wall = _wall(torch, run)
        issue, device = _behind_sleep(torch, run, wall)
        rows.append({"steps_per_graph": s, "capture_s": round(capture_s, 4),
                     "graph_pool_mb": round(pool_mb, 2), "replays": 240 // s,
                     "wall_ms_per_step": round(1e3 * wall / 240, 5),
                     "host_issue_ms_per_step": round(1e3 * issue / 240, 5),
                     "device_ms_per_step": round(1e3 * device / 240, 5)})
        del captured, g, run
    graphs.clear_graphs()
    out["steps_per_graph"] = rows


def _trace(torch, smc, out: dict, models, ys, gen, path: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    y = ys[:STEPS[0] + 1]
    smc.batched_log_likelihood(gen, models, cs.DT_N, cs.DT_M, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        smc.batched_log_likelihood(gen, models, cs.DT_N, cs.DT_M, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(cs.PROFILE_SETTLE_S)  # the trace's last records reach the profiler late
    prof.export_chrome_trace(path)
    avg = prof.key_averages()
    host = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    device = sorted((e for e in avg if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                     key=lambda e: e["ts"])
    gaps = [b["ts"] - (a["ts"] + a["dur"]) for a, b in zip(kernels, kernels[1:])]
    launches = sorted(e["ts"] for e in events if e.get("cat") == "cuda_runtime"
                      and e.get("name") == "cudaGraphLaunch")
    between = [b - a for a, b in zip(launches, launches[1:])]
    out["trace"] = {
        "wall_ms": round(1e3 * wall, 4),
        "host_top": [{"name": e.key, "count": e.count, "self_cpu_us": round(e.self_cpu_time_total, 1)}
                     for e in host[:30]],
        "device_top": [{"name": e.key[:80], "count": e.count,
                        "device_us": round(e.self_device_time_total, 1)} for e in device[:15]],
        "device_events": len(kernels),
        "device_busy_us": round(sum(e["dur"] for e in kernels), 1),
        "device_span_us": round(kernels[-1]["ts"] + kernels[-1]["dur"] - kernels[0]["ts"], 1)
        if kernels else 0.0,
        "device_gap_us": {"sum": round(sum(gaps), 1), "max": round(max(gaps, default=0.0), 1),
                          "over_10us": sum(g > 10 for g in gaps)},
        "graph_launches": len(launches),
        "host_us_between_graph_launches": {
            "mean": round(sum(between) / len(between), 2) if between else None,
            "min": round(min(between), 2) if between else None,
            "max": round(max(between), 2) if between else None},
    }
    # which runtime calls a host read leaves in the trace
    x = torch.ones(4, device="cuda")
    ev = torch.cuda.Event()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (x * 2).sum().item()
        ev.record()
        ev.synchronize()
        torch.cuda.synchronize()
    out["trace"]["host_read_runtime_calls"] = sorted(
        {e.key: e.count for e in prof.key_averages() if e.key.startswith("cuda")}.items())


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="replay_trace.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("replay_trace: needs a CUDA device")
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.kernels import _build

    _build.library()
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    models = smc.ucsv_model(torch.tensor(cs.JAX_MEAN, device="cuda").expand(cs.DT_M, 4))
    ys = cs.series(torch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {"card": smi, "shape": f"{cs.DT_M}x{cs.DT_N}"}
    _filter_parts(torch, smc, out, models, ys, gen)
    _host_costs(torch, out, gen)
    _trace(torch, smc, out, models, ys, gen,
           os.path.splitext(args.out)[0] + "_chrome.json")
    _steps_per_graph(torch, smc, out, models, ys, gen)
    for key, val in out.items():
        if key != "card":
            print(json.dumps({"part": key, "card": smi, key: val}), flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
