"""Run one benchmark cell once on the card and print its result's line:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits 2 without a card (or with fewer than the
cell asks for), 3 where JAX or the JAX package was loaded."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one host thread for torch's CPU ops: the run is one process whose host
# work is launches and small tensors, and idle worker threads only contend
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
# Triton's kernel cache at a fixed path inside the checkout: only a cell's
# first run there compiles (the nvcc library stays in the package's _build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "port_bench", ".cache", "triton")
sys.path.insert(0, ROOT)

from port_bench.harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
