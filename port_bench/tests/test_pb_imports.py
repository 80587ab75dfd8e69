"""Nothing a run loads or opens is JAX, the JAX package or a file of
``benchmarks/``: top-level module names compared whole."""
import ast
import json
import subprocess
import sys

from port_bench.harness import catalog
from port_bench.harness.imports import FORBIDDEN, forbidden_loaded

PROBE = r"""
import json, os, sys, time
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
sys.path.insert(0, {root!r})
from port_bench.harness import cli
from port_bench.tests._runs import sizes
res = cli.run_cell("filters_lg_64x65536", 7, 0.5, False, "cpu", time.perf_counter(),
                   overrides=sizes("filters_lg_64x65536")["params"])
print(json.dumps({{"modules": sorted(sys.modules), "opened": sorted(set(opened)),
                   "correct": res["correct"]}}))
"""


def test_top_level_names_compared_whole():
    assert forbidden_loaded(["sequential_monte_carlo_tpu_torch.ops.graphs", "numpy"]) == []
    assert forbidden_loaded(["sequential_monte_carlo_tpu.kernels", "jaxlib.xla_client",
                             "jax_extra"]) == ["jaxlib.xla_client",
                                               "sequential_monte_carlo_tpu.kernels"]


def test_sources_import_nothing_forbidden():
    for path in catalog.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)


def test_a_run_loads_and_opens_nothing_forbidden():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(catalog.ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=catalog.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["correct"]
    assert forbidden_loaded(seen["modules"]) == []
    assert "sequential_monte_carlo_tpu_torch" in seen["modules"]
    bench_files = str(catalog.ROOT / "benchmarks") + "/"
    assert not [p for p in seen["opened"]
                if p.startswith(bench_files) or p.startswith("benchmarks/")]
