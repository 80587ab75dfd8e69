#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's runs on one GPU.

    python3 tools/profile_port.py [--out profile_port.json]

For each cell — density-tempered SMC on LG at BASELINE config 4 (512 × 1024,
T=100, chain=3) with (a) the systematic inner filter at every step and
(b) the stratified one triggered at ESS < N/2; 512 parallel LG filters at θ*
(config 3); online SMC² on UC-SV at 512 × 1024 (bench.py) and at the
flagship 512 × 8192; the 512 × 1024 SMC² and the LG filters with the
auxiliary particle filter inside; one θ's UC-SV filter_sequence at N=8192
with a quantile summary, smoothed_marginals on UC-SV at N=8192 (the blocked
backward pass), posterior_smoothed_paths (8 θ × 64 paths, N=8192, from a
512-θ cloud at chip_smoke.JAX_MEAN), 10 sweeps of particle Gibbs on UC-SV at
241 × 8192 ("bs" and "as"; chip_smoke.py runs 50) and 100 sweeps of the LG
chain at T=60, N=128; online SMC² on UC-SV written with the model DSL (no
fused propagate kernel) at 512 × 1024; the inflation example at --full sizes
without figures (UC 512 × 1024 chain 3, UC-SV 512 × 8192 chain 5, each with
its filter at θ̂, FFBS and posterior mixture) — it runs the
cell once to warm up, once unprofiled for the wall-clock, and once under
``torch.profiler`` for the device time by kernel, the device's busy share
(Σ device time / wall-clock), the host's CPU time and the unprofiled run's
peak of allocated device memory. Each cell runs ``graphed`` (the default
path: the masked filter, SMC²'s online step, ``filter_sequence``, the
forward bank, and particle Gibbs's and conditional SMC's sweeps replay
their captured CUDA graphs where the route is captured, ``ops/graphs.py``),
then ``eager`` (inside ``disable_graphs()``).
Prints one JSON line per cell and mode and writes them all to ``--out``;
``--cells`` picks cells by name. Needs a CUDA device.

    python3 tools/profile_port.py --cells smc2_ucsv_512x8192   # the flagship
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def _cells(torch):
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    y_lg = torch.tensor(cs.lg_series(), device="cuda")
    theta = torch.tensor(cs.LG_THETA, device="cuda").expand(cs.DT_M, 3)

    def dt(inner):
        sampler = smc.SMC2(smc.lg_model, prior_from_spec(cs.LG_PRIOR_SPEC, device="cuda"),
                           smc.SMCConfig(n_particles=cs.DT_N, n_theta=cs.DT_M, chain=cs.DT_CHAIN,
                                         ess_threshold=0.5, inner=smc.PFConfig(*inner)))
        return lambda seed: smc.density_tempered(
            sampler, torch.Generator(device="cuda").manual_seed(seed), y_lg)

    def filters(inner):
        return lambda seed: smc.batched_log_likelihood(
            torch.Generator(device="cuda").manual_seed(seed), smc.lg_model(theta), cs.DT_N,
            cs.DT_M, y_lg, smc.PFConfig(*inner))

    return {"dt_a_systematic": dt(("systematic", 1.0)),
            "dt_b_stratified_ess0.5": dt(("stratified", 0.5)),
            "filters_lg_512": filters(("systematic", 1.0)),
            "smc2_ucsv_512x1024": lambda seed: cs.run_slice(torch, 1024, seed),
            "smc2_ucsv_512x8192": lambda seed: cs.run_slice(torch, 8192, seed),
            "filters_lg_apf_512": filters(cs.APF),
            "smc2_ucsv_apf_512x1024": lambda seed: cs.run_apf_smc2(
                torch, smc.ucsv_model, cs.PRIOR_SPEC, cs.series(torch, "cuda"), cs.CHAIN, seed),
            **_smoothing_cells(torch, smc, prior_from_spec),
            **_dsl_inflation_cells(torch, smc, prior_from_spec)}


def _dsl_inflation_cells(torch, smc, prior_from_spec):
    """chip_smoke.py's dsl phase's SMC² and its inflation phase's example."""
    import tempfile

    from sequential_monte_carlo_tpu_torch.examples import inflation

    cfg = smc.SMCConfig(n_particles=1024, n_theta=512, chain=cs.CHAIN, ess_threshold=0.5)
    dsl = smc.SMC2(cs.ucsv_dsl(smc, torch), prior_from_spec(cs.PRIOR_SPEC, device="cuda"), cfg)
    y = cs.series(torch, "cuda")
    outdir = tempfile.mkdtemp(prefix="profile_inflation_")
    return {
        "smc2_ucsv_dsl_512x1024": lambda seed: dsl.run(
            torch.Generator(device="cuda").manual_seed(seed), y),
        # the example's seeds are its own: every run is the same run
        "inflation_full": lambda seed: inflation.run_example(
            inflation.FULL_SIZES, outdir, figures=False, device="cuda"),
    }


def _smoothing_cells(torch, smc, prior_from_spec):
    """The per-θ filter, smoother and particle-Gibbs cells (chip_smoke.py's
    per_theta, smoothing and pg phases)."""
    from sequential_monte_carlo_tpu_torch.analysis import weighted_quantile

    y = cs.series(torch, "cuda")
    ucsv = smc.ucsv_model(torch.tensor(cs.JAX_MEAN, device="cuda"))
    cloud = torch.tensor(cs.JAX_MEAN, device="cuda").expand(cs.DT_M, 4).contiguous()
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)  # noqa: E731

    def pg(model_fn, spec, ys, cfg):
        prior = prior_from_spec(spec, device="cuda")
        return lambda seed: smc.particle_gibbs(gen(seed), model_fn, prior, ys, cfg)

    return {
        "filter_sequence_ucsv_1x8192": lambda seed: smc.filter_sequence(
            gen(seed), ucsv, cs.FFBS_N, y, summarize=lambda s: weighted_quantile(
                s.particles[:, 0], torch.exp(s.log_weights), [0.05, 0.5, 0.95])),
        "ffbs_ucsv_8192": lambda seed: smc.smoothed_marginals(gen(seed), ucsv, cs.FFBS_N, y),
        "posterior_paths_8x8192": lambda seed: smc.posterior_smoothed_paths(
            gen(seed), smc.ucsv_model, cloud, torch.zeros(cs.DT_M, device="cuda"), y, cs.FFBS_N,
            n_theta=cs.MIX_THETA, n_paths=cs.MIX_PATHS),
        **{f"pg_ucsv_{m}_241x8192_10sweeps": pg(smc.ucsv_model, cs.PRIOR_SPEC, y, smc.PGConfig(
            n_particles=cs.PG_N, sweeps=10, chain=cs.PG_CHAIN, method=m)) for m in ("bs", "as")},
        "pg_lg_60x128_100sweeps": pg(smc.lg_model, cs.LG_PRIOR_SPEC,
                                     torch.tensor(cs.lg_series(cs.PG_LG_T), device="cuda"),
                                     smc.PGConfig(n_particles=cs.PG_LG_N, sweeps=100,
                                                  chain=cs.PG_CHAIN)),
    }


def _profile(torch, fn, seed: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(seed)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn(seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    cs.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(seed)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
        time.sleep(cs.PROFILE_SETTLE_S)  # the trace's last records reach the profiler late
    launches = {k: v for k, v in cs.launch_counts().items() if v}
    events = prof.key_averages()
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched
    device = sorted(((e.key, e.self_device_time_total, e.count) for e in events
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                    key=lambda r: -r[1])
    # a collective's device events (NCCL's kernel and its "nccl:" range,
    # gloo's "gloo:" range) last while the rank waits for the others: a
    # rendezvous, not the program's work, so they stay out of device time
    # and busy share
    coll_us = sum(r[1] for r in device if r[0].startswith(("nccl", "gloo:")))
    device_us = sum(r[1] for r in device) - coll_us
    return {
        "wall_s": wall, "wall_profiled_s": wall_prof, "peak_allocated_mb": peak_mb,
        "device_s": device_us / 1e6,
        "collective_device_s": coll_us / 1e6,
        "device_calls": sum(r[2] for r in device),
        "device_busy": device_us / 1e6 / wall_prof,
        "host_self_cpu_s": sum(e.self_cpu_time_total for e in events
                               if e.device_type == DeviceType.CPU) / 1e6,
        "launches": launches,
        "top_device": [{"name": k[:80], "us": us, "calls": n, "us_per_call": us / n}
                       for k, us, n in device[:8]],
    }


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--out", default="profile_port.json")
    p.add_argument("--cells", nargs="*", help="cells to run (default: all)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.kernels import _build

    _build.library()
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[0]
    rows = []
    cells = _cells(torch)
    unknown = set(args.cells or ()) - set(cells)
    if unknown:
        raise SystemExit(f"profile_port: unknown cells {sorted(unknown)}; one of {sorted(cells)}")
    for name, fn in cells.items():
        if args.cells and name not in args.cells:
            continue
        for mode in ("graphed", "eager"):
            with smc.disable_graphs() if mode == "eager" else contextlib.nullcontext():
                row = {"cell": name, "mode": mode, "card": smi, **_profile(torch, fn, 0)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
