"""Readings of a cell's compared numbers over many seeds, and of its
control, in one process: the lower and upper readings its limits are set
from (PERF.md gives them beside each limit).

    python3 port_bench/calibrate.py --workload <cell> --seeds 11 12 … \\
        --seconds 45 --control-seeds 21 22 23 --control-seconds 90 \\
        --fault move_unchanged --fault-seeds 31 32 33 --out <file>

Each seed runs the cell's entry as a run does (a warm-up call, the closed
loop for ``--seconds``, the check), at the cell's own sizes; the control
puts the plain reference, in the precision below the configuration's, in
the program's place; the fault (:mod:`port_bench.harness.faults`) is
planted in the program for its seeds, after the sound and control
readings. One fault a process: where several were planted one after
another in one process, each later fault read as the first did. The
numbers are the check's, every one of them, whether the
workload holds a limit for it or not.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "port_bench", ".cache", "triton")
sys.path.insert(0, ROOT)

from port_bench.harness import cli, faults, window  # noqa: E402


def readings(name: str, seeds, seconds: float, program: str, label: str = "") -> list:
    rows = []
    for seed in seeds:
        _, _, entry, setup_s = cli.make_entry(name, seed, "cuda", time.perf_counter(),
                                              program=program)
        win = window.run(entry.torch, entry, seconds, "cuda")
        checked = entry.check()
        row = {"seed": seed, "program": label or program, "calls": len(win["calls"]),
               "window_s": win["window_s"], "setup_s": setup_s, "failed": checked["failed"],
               "numbers": checked["numbers"], "info": checked["info"]}
        cli.say(json.dumps(row))
        rows.append(row)
    return rows


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=45.0)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seconds", type=float, default=60.0)
    p.add_argument("--fault", choices=faults.NAMES)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    rows = readings(args.workload, args.seeds, args.seconds, "program")
    rows += readings(args.workload, args.control_seeds, args.control_seconds, "control")
    if args.fault:
        import sequential_monte_carlo_tpu_torch as smc

        faults.plant(smc, args.fault)
        rows += readings(args.workload, args.fault_seeds, args.seconds, "program", args.fault)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "rows": rows}, f, indent=1)
    for key in sorted({k for r in rows for k in r["numbers"]}):
        for program in ("program", "control", args.fault):
            vals = [r["numbers"][key] for r in rows if r["program"] == program]
            if vals:
                print(f"{key} {program}: min={min(vals)!r} max={max(vals)!r} n={len(vals)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
