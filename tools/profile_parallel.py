#!/usr/bin/env python3
"""Where the time goes in sharded SMC² on one card.

    python3 tools/profile_parallel.py [--out profile_parallel.json] [--n 1024 8192]
        [--worlds 1:nccl 2:gloo 2:gloo:1x2] [--modes graphed eager]

Online SMC² on UC-SV at bench.py's configuration (M=512, T=241, chain=5)
at each N, sharded (``parallel.ShardedSMC2``) over each world of
``--worlds`` (ranks:backend[:RθxRp]; by default one NCCL rank, then two
gloo ranks sharing the card; on four cards ``4:nccl`` puts a rank on each;
the mesh is θ over all ranks unless RθxRp names a (θ, particle) mesh, e.g.
``2:gloo:1x2`` or ``4:gloo:2x2``), each rank a worker process of this
script on cuda:{rank % cards}, once for each of ``--modes``: "graphed" (the
mesh's loops replay captured graphs, a step's collectives run between its
segments; its row adds the routes' graph and segment launches, cuts a step
and the graph pool) and "eager" (inside ``disable_graphs()``). Each rank runs the
cell once to warm up, once unprofiled for the wall-clock and once under
``torch.profiler`` (``tools/profile_port.py::_profile``): its device time
and busy share (the collectives' device events apart, in
``collective_device_s``: they last while the rank waits for the others),
host CPU time, launches, and the collectives' calls, bytes and host
seconds (``ops.sharding.collective_stats``) of the profiled run. The card's busy
share is the ranks' device time summed over the longest profiled wall (one
card runs one process's kernels at a time; on several cards, the mean of
the ranks' busy shares). Every world's θ, log ω and log Z must equal the
first world's bit for bit at each N, or the script fails, but on a mesh
that shards particles: there the rows are normalized in torch, where one
rank normalizes inside K2, so the run parts from the first world's at
ancestor ties; its ranks must agree with each other bit for bit, and each
row reports its posterior mean and the first world's. Prints one JSON line
per rank and writes them to ``--out``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from tools.profile_port import _profile  # noqa: E402

WORKER = "--worker"


def worker(n: int, rank: int, world: int, backend: str, store: str, out: str,
           mesh_shape: str, mode: str) -> int:
    import contextlib

    import torch

    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch import parallel
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
    from sequential_monte_carlo_tpu_torch.ops.sharding import collective_stats

    device = parallel.initialize_distributed(init_method=f"file://{store}", num_processes=world,
                                             process_id=rank, backend=backend)
    cfg = smc.SMCConfig(n_particles=n, n_theta=512, chain=cs.CHAIN, ess_threshold=0.5,
                        inner=smc.PFConfig("systematic", 1.0))
    mesh = parallel.make_mesh(*map(int, mesh_shape.split("x")))
    sh = parallel.ShardedSMC2(smc.SMC2(smc.ucsv_model, prior_from_spec(
        cs.PRIOR_SPEC, device=device), cfg), mesh)
    y = cs.series(torch, device)

    last = {}

    def run(seed):
        collective_stats.clear()  # what remains is the last (profiled) run's
        last["routes"] = cs._routes_now()
        with smc.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            state, infos = sh.run(torch.Generator(device=device).manual_seed(seed), y)
        np.savez(f"{out}/{rank}.npz", **{k: getattr(state, k).cpu().numpy()
                                         for k in ("theta", "log_omega", "log_z")})
        last["inner_steps"] = cs._schedule(infos, cs.CHAIN, [])
        return state, infos

    row = {"cell": f"smc2_ucsv_512x{n}_{world}rank_{backend}_{mesh_shape}", "mode": mode,
           "rank": rank, "mesh": list(mesh.shape),
           **_profile(torch, run, cs.SEED),
           "collectives": {k: round(v, 6) for k, v in collective_stats.items()},
           **cs._routes_since(last.pop("routes")), "pool_mb": round(cs._graph_pool_mb(torch), 1),
           **last}
    torch.distributed.destroy_process_group()
    with open(f"{out}/{rank}.json", "w") as f:
        json.dump(row, f)
    return 0


def main() -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--out", default="profile_parallel.json")
    p.add_argument("--n", type=int, nargs="*", default=[1024, 8192])
    p.add_argument("--worlds", nargs="*", default=["1:nccl", "2:gloo"],
                   help="ranks:backend[:RθxRp]")
    p.add_argument("--modes", nargs="*", default=["graphed", "eager"],
                   choices=["graphed", "eager"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_parallel: no CUDA device")
    from sequential_monte_carlo_tpu_torch.kernels import _build

    _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().replace("\n", "; ")
    rows = []
    for n in args.n:
        first = None
        for spec, mode in [(s, m) for s in args.worlds for m in args.modes]:
            world, backend, *shape = spec.split(":")
            world = int(world)
            mesh_shape = shape[0] if shape else f"{world}x1"
            particle_mesh = int(mesh_shape.split("x")[1]) > 1
            out = tempfile.mkdtemp(prefix="smc_profile_parallel_")
            procs = [subprocess.Popen([sys.executable, __file__, WORKER, str(n), str(r),
                                       str(world), backend, f"{out}/store", out, mesh_shape,
                                       mode])
                     for r in range(world)]
            for p_ in procs:
                if p_.wait(timeout=1800) != 0:
                    raise SystemExit(f"profile_parallel: a rank of {world} ({backend}) failed")
            ranks = []
            for r in range(world):
                with open(f"{out}/{r}.json") as f:
                    ranks.append({**json.load(f), "card": smi})
                with np.load(f"{out}/{r}.npz") as z:
                    got = {k: z[k] for k in z.files}
                first = first or got
                rank0 = got if r == 0 else rank0
                ref = rank0 if particle_mesh else first
                if not all(np.array_equal(got[k], ref[k]) for k in ref):
                    raise SystemExit(f"profile_parallel: {spec}, rank {r}, 512x{n}: θ differs "
                                     f"from {'rank 0' if particle_mesh else 'the first world'}'s")
                ranks[-1]["bitwise_as_first_world"] = (
                    all(np.array_equal(got[k], first[k]) for k in first))
                ranks[-1]["posterior_mean"] = cs._mean(got["theta"], got["log_omega"]).tolist()
                ranks[-1]["first_world_posterior_mean"] = cs._mean(
                    first["theta"], first["log_omega"]).tolist()
            cards = min(world, torch.cuda.device_count())
            card_busy = (sum(x["device_s"] for x in ranks) / max(x["wall_profiled_s"]
                                                                 for x in ranks)) / cards
            for x in ranks:
                x["card_busy"] = card_busy
                print(json.dumps(x), flush=True)
            rows += ranks
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [WORKER]:
        a = sys.argv[2:]
        sys.exit(worker(int(a[0]), int(a[1]), int(a[2]), a[3], a[4], a[5], a[6], a[7]))
    sys.exit(main())
