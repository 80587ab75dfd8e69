#!/usr/bin/env python3
"""Posterior means of sharded SMC² over seeds, against one process's.

    python3 tools/seed_spread.py [--n 1024] [--mesh 1x2] [--seeds 0 1 2]
        [--one-seeds 12] [--out seed_spread.json]

Online SMC² on UC-SV at bench.py's configuration (M=512, T=241, chain=5,
the systematic inner filter) at N particles: each seed of ``--seeds`` on a
(θ, particle) mesh of gloo ranks sharing cuda:0 (``parallel.ShardedSMC2``),
and seeds 0 .. ``--one-seeds`` − 1 in this process. On a mesh that shards
particles the rows are normalized in torch, where one process normalizes
inside K2, so single runs part at ancestor ties; this compares the two as
distributions: each side's mean and spread of the posterior means and a
Welch t per component. Prints one JSON line per run and a summary line,
and writes them to ``--out``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

WORKER = "--worker"


def _sampler(n: int, device, mesh=None):
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch import parallel
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    cfg = smc.SMCConfig(n_particles=n, n_theta=512, chain=cs.CHAIN, ess_threshold=0.5,
                        inner=smc.PFConfig("systematic", 1.0))
    sampler = smc.SMC2(smc.ucsv_model, prior_from_spec(cs.PRIOR_SPEC, device=device), cfg)
    return sampler if mesh is None else parallel.ShardedSMC2(sampler, mesh)


def _run(torch, sampler, seed: int, device) -> dict:
    import sequential_monte_carlo_tpu_torch as smc

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, infos = sampler.run(torch.Generator(device=device).manual_seed(seed),
                               cs.series(torch, device))
    torch.cuda.synchronize()
    return {"seed": seed, "posterior_mean": smc.expected_parameters(state).cpu().tolist(),
            "inner_steps": cs._schedule(infos, cs.CHAIN, []),
            "wall_s": time.perf_counter() - t0}


def worker(rank: int, world: int, store: str, out: str, n: int, mesh_shape: str,
           seeds: list) -> int:
    import torch

    from sequential_monte_carlo_tpu_torch import parallel

    device = parallel.initialize_distributed(init_method=f"file://{store}", num_processes=world,
                                             process_id=rank, backend="gloo")
    sampler = _sampler(n, device, parallel.make_mesh(*map(int, mesh_shape.split("x"))))
    rows = [_run(torch, sampler, s, device) for s in seeds]
    torch.distributed.destroy_process_group()
    with open(f"{out}/{rank}.json", "w") as f:
        json.dump(rows, f)
    return 0


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--mesh", default="1x2", help="RθxRp of the sharded runs")
    p.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    p.add_argument("--one-seeds", type=int, default=12)
    p.add_argument("--out", default="seed_spread.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("seed_spread: no CUDA device")
    world = int(np.prod([int(v) for v in args.mesh.split("x")]))
    out = tempfile.mkdtemp(prefix="smc_seed_spread_")
    procs = [subprocess.Popen([sys.executable, __file__, WORKER, str(r), str(world),
                               f"{out}/store", out, str(args.n), args.mesh,
                               json.dumps(args.seeds)]) for r in range(world)]
    for proc in procs:
        if proc.wait(timeout=3600) != 0:
            raise SystemExit(f"seed_spread: a rank of the {args.mesh} mesh failed")
    ranks = []
    for r in range(world):
        with open(f"{out}/{r}.json") as f:
            ranks.append(json.load(f))
    if any(x["posterior_mean"] != y["posterior_mean"] for rk in ranks[1:]
           for x, y in zip(rk, ranks[0])):
        raise SystemExit("seed_spread: the ranks' posterior means differ")
    sampler = _sampler(args.n, "cuda")
    one = [_run(torch, sampler, s, "cuda") for s in range(args.one_seeds)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    rows = ([{"run": f"mesh_{args.mesh}", "n": args.n, **x} for x in ranks[0]]
            + [{"run": "one_process", "n": args.n, **x} for x in one])
    a = np.array([x["posterior_mean"] for x in ranks[0]])
    b = np.array([x["posterior_mean"] for x in one])
    var_a = a.var(0, ddof=1) / len(a) if len(a) > 1 else np.zeros(a.shape[1])
    summary = {"n": args.n, "mesh": args.mesh, "card": smi,
               "sharded_mean": a.mean(0).tolist(), "one_process_mean": b.mean(0).tolist(),
               "one_process_sd": b.std(0, ddof=1).tolist(),
               "sharded_sd": a.std(0, ddof=1).tolist() if len(a) > 1 else None,
               "welch_t": ((a.mean(0) - b.mean(0))
                           / np.sqrt(var_a + b.var(0, ddof=1) / len(b))).tolist()}
    for row in rows + [summary]:
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"runs": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [WORKER]:
        a = sys.argv[2:]
        sys.exit(worker(int(a[0]), int(a[1]), a[2], a[3], int(a[4]), a[5], json.loads(a[6])))
    sys.exit(main())
