"""A model that no cell runs comes in by new files alone: in a copy of the
benchmark, the files of ``new_model/`` (the port's canonical SV model,
``sv_model``: a series kind, a reference model, a prior kind, a step
count, a configuration, a workload on the ``filters`` entry and its CPU
sizes) are added beside the others and their entries appended to
``BENCHMARK.json``; no file that was there changes. The copy's cell then
runs on the CPU, in a process whose ``port_bench`` is the copy's: sound it
is correct, with each inner fault planted it is not, and its
``inner_step_mfu`` and ``propagate_roofline`` read the SV model's counts
from a made trace."""
import json
import os
import shutil
import subprocess
import sys

from port_bench.harness import catalog

from ._runs import CELLS

NEW = CELLS.parent / "new_model"
CELL, CONFIG = "filters_sv_64x4096", "sv_returns"

PROBE = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
import port_bench
from types import SimpleNamespace
from port_bench.harness import catalog, cli, faults
from port_bench.harness.trace import Trace
from port_bench.tests._runs import run
import sequential_monte_carlo_tpu_torch as smc

out = {{"bench_dir": str(catalog.BENCH_DIR)}}
res = run({cell!r}, seed=2**31 + 5)
out["sound"] = [res["correct"], res["checks"], sorted(res["metrics"])]
trace = Trace([("step_kernel", 0, 40_000), ("void resample_count_kernel<1>(x)", 40_000, 90_000)],
              [], (0, 100_000))
shape = {{"rows": 64, "particles": 4096, "planes": 1, "step_params": 3, "model": "sv",
          "carry": False}}
ctx = SimpleNamespace(trace=trace, shape=shape,
                      traced_calls=[(0, 1e-4, {{"inner_steps": 1, "particle_steps": 0}})])
out["readings"] = {{name: catalog.load_module("metrics", name).read(ctx)
                   for name in ("inner_step_mfu", "propagate_roofline")}}
out["faults"] = {{}}
for name in faults.INNER:
    saved = {{step: getattr(smc.ops.batched_filter, step) for step in faults.STEPS}}
    faults.plant(smc, name)
    res = run({cell!r}, seed=2**31 + 6)
    out["faults"][name] = [res["correct"], res["checks"]]
    for step, fn in saved.items():
        setattr(smc.ops.batched_filter, step, fn)
print(json.dumps(out))
"""


def _add_model(tmp_path):
    """(the copy's root, its files' bytes before the model came in)."""
    root = tmp_path / "checkout"
    shutil.copytree(catalog.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(catalog.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    for src in NEW.rglob("*"):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = root / "port_bench" / src.relative_to(NEW)
            assert not dst.exists(), dst  # new files only
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONFIG, "file": f"port_bench/configs/{CONFIG}.json",
                             "source": "Kim, Shephard and Chib (1998), Rev. Econ. Stud. 65(3)",
                             "reduced": [], "why": "a model no cell runs"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "likelihood_bank",
                               "chips": 1, "why": "a bank of SV likelihoods"})
    for metric in bench["per_layer"]:
        if metric["name"] in ("inner_step_mfu", "propagate_roofline"):
            metric["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root, before


def test_a_new_model_comes_in_by_files_alone(tmp_path):
    root, before = _add_model(tmp_path)
    changed = [str(p) for p, data in before.items() if p.read_bytes() != data]
    assert changed == [str(root / "BENCHMARK.json")]
    # BENCHMARK.json only gained entries: every old one is there unchanged
    old, new = json.loads(before[root / "BENCHMARK.json"]), json.loads(
        (root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end"):
        assert new[key][:len(old[key])] == old[key]
    for a, b in zip(old["per_layer"], new["per_layer"]):
        assert {**b, "workloads": b["workloads"][:len(a["workloads"])]} == a

    env_path = [str(root), str(catalog.ROOT)]
    out = subprocess.run([sys.executable, "-c", PROBE.format(cell=CELL)], capture_output=True,
                         text=True, timeout=300, cwd=root,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(env_path),
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["bench_dir"] == str(root / "port_bench")
    correct, checks, metrics = seen["sound"]
    assert correct, checks
    assert metrics == ["particle_steps_per_s", "runs_per_s", "setup_s"]
    # 64 x 4096 rows: 16 bytes a particle a step over 3.35 TB/s, against the
    # SV update's 1 normal and 8 operations (bytes bind)
    least = 16 * 64 * 4096 / 3.35e12
    assert abs(seen["readings"]["inner_step_mfu"] - 100 * least / 1e-4) < 1e-9
    need = (4 * 64 * 4096 * 3 + 4 * 64 * 5) / 3.35e12
    assert abs(seen["readings"]["propagate_roofline"] - 100 * need / 40e-6) < 1e-9
    for name, (correct, checks) in seen["faults"].items():
        assert not correct, (name, checks)
