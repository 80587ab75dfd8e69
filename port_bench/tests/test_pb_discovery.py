"""A configuration, a workload and metrics added as new files in a copy of
the benchmark run with no file of it edited."""
import json
import shutil
import sys
import time
from types import SimpleNamespace

import torch

from port_bench.harness import catalog, cli
from port_bench.harness.trace import Trace

from ._runs import cells, sizes

NEW_E2E = '''"""Calls a second, twice over (a test's metric)."""


def read(ctx):
    return 2 * len(ctx.window["calls"]) / ctx.window["window_s"]
'''
NEW_LAYER = '''"""Device operations named like K1 in the traced span (a test's metric)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return float(len(ctx.trace.kernels(("resample_count_kernel",))))
'''


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(catalog.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(catalog.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_added_files_are_found_and_run(tmp_path):
    root = _copy(tmp_path)
    bench_dir = root / "port_bench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    config = json.loads((bench_dir / "configs" / "lg_ar1_large_n.json").read_text())
    config.update(name="lg_ar1_persistent",
                  prior=[["truncated_normal", 0.9, 0.05, 0.8, 1.0], ["lognormal", -1.0, 0.5],
                         ["lognormal", 0.0, 0.5]])
    (bench_dir / "configs" / "lg_ar1_persistent.json").write_text(json.dumps(config))
    workload = json.loads((bench_dir / "workloads" / "filters_lg_64x65536.json").read_text())
    workload["params"].update(m=4, n=1024)
    (bench_dir / "workloads" / "filters_lg_persistent.json").write_text(json.dumps(workload))
    (bench_dir / "metrics" / "calls_twice_per_s.py").write_text(NEW_E2E)
    (bench_dir / "metrics" / "k1_events.py").write_text(NEW_LAYER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lg_ar1_persistent", "source": "a test", "reduced": [],
                             "file": "port_bench/configs/lg_ar1_persistent.json", "why": "a test"})
    bench["workloads"].append({"name": "filters_lg_persistent", "config": "lg_ar1_persistent",
                               "traffic": "likelihood_bank_small", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_twice_per_s", "unit": "runs/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["filters_lg_persistent"]})
    bench["per_layer"].append({"name": "k1_events", "unit": "count", "better": "lower",
                               "source": "device_trace", "layer": "kernels",
                               "moves": "particle_steps_per_s",
                               "workloads": ["filters_lg_persistent"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path, data in before.items():  # nothing that was there changed
        assert path.read_bytes() == data

    res = cli.run_cell("filters_lg_persistent", 5, 1.0, False, "cpu", time.perf_counter(),
                       bench_dir=bench_dir, overrides={"t": 12, "check_calls": 3})
    assert set(res["metrics"]) == {"particle_steps_per_s", "runs_per_s",
                                   "setup_s", "calls_twice_per_s"}
    assert abs(res["metrics"]["calls_twice_per_s"]["value"]
               - 2 * res["metrics"]["runs_per_s"]["value"]) < 1e-9
    assert res["correct"], res["checks"]
    layer = [m["name"] for m in catalog.metrics_for(bench, "filters_lg_persistent", True)]
    assert "k1_events" in layer and "rejuvenations_per_run" not in layer
    reader = catalog.load_module("metrics", "k1_events", bench_dir)
    trace = Trace([("void resample_count_kernel<1>(float*)", 10, 20), ("step_kernel", 20, 30)],
                  [], (0, 100))
    assert reader.read(SimpleNamespace(trace=trace)) == 1.0
    assert reader.read(SimpleNamespace(trace=None)) is None
    sys.modules.pop("port_bench.metrics.k1_events", None)


def test_a_metric_that_loads_jax_leaves_no_result(tmp_path, monkeypatch, capsys):
    """A metric reader added later that loads JAX, even through another
    module: the run names it and prints no result."""
    root = _copy(tmp_path)
    stubs = tmp_path / "stubs"
    (stubs / "jax").mkdir(parents=True)
    (stubs / "jax" / "__init__.py").write_text("")
    (stubs / "helper_of_a_reader.py").write_text("import jax  # noqa: F401\n")
    monkeypatch.syspath_prepend(str(stubs))
    (root / "port_bench" / "metrics" / "loads_jax.py").write_text(
        "def read(ctx):\n    import helper_of_a_reader  # noqa: F401\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "loads_jax", "unit": "count", "better": "lower",
                                "bound": 0.05, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        res = cli.run_cell("filters_lg_64x65536", 5, 0.5, False, "cpu", time.perf_counter(),
                           bench_dir=root / "port_bench",
                           overrides={**sizes("filters_lg_64x65536")["params"], "t": 12,
                                      "check_calls": 3})
        assert res["metrics"]["loads_jax"]["value"] == 1.0
        capsys.readouterr()
        assert cli.emit(res) == 3
        out, err = capsys.readouterr()
        assert out == "" and "'jax'" in err
    finally:
        for name in ("jax", "helper_of_a_reader", "port_bench.metrics.loads_jax"):
            sys.modules.pop(name, None)
    capsys.readouterr()
    assert cli.emit(res) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metrics"]


def test_a_workload_sets_the_program_s_options():
    """A workload's ``inner`` and ``sampler`` objects reach the program's
    ``PFConfig`` and ``SMCConfig`` whole: the APF and the exchange come in
    as data."""
    import sequential_monte_carlo_tpu_torch as smc

    bench = catalog.benchmark()
    cell = catalog.cell("smc2_ucsv_512x8192", bench)
    cell["params"] = {**cell["params"], **sizes("smc2_ucsv_512x8192")["params"],
                      "inner": {"resampling": "stratified", "ess_threshold": 0.5,
                                "algorithm": "apf"},
                      "sampler": {"chain": 3, "ess_threshold": 0.4, "acc_threshold": 0.2,
                                  "elastic_pad": "full"}}
    entry = catalog.load_module("entries", "smc2").Entry(torch, smc, cell, 3, "cpu")
    cfg = entry.sampler.config
    assert cfg.inner == smc.PFConfig("stratified", 0.5, algorithm="apf")
    assert (cfg.chain, cfg.ess_threshold, cfg.acc_threshold, cfg.elastic_pad) == (
        3, 0.4, 0.2, "full")
    assert (entry.chain, entry.ess_threshold, entry.shape["carry"]) == (3, 0.4, True)


def test_trace_readers_on_a_made_trace():
    """The per-layer readers on a hand-made trace: two steps, K1 and K2 each
    once a step, a glue kernel overlapping K2, one graph launch."""
    ops = [("void resample_count_kernel<3>(x)", 0, 60), ("step_kernel", 60, 110),
           ("elementwise", 100, 130), ("void resample_count_kernel<3>(x)", 200, 260),
           ("step_kernel", 260, 310)]
    host = [("cudaGraphLaunch", 0, 5), ("cudaStreamSynchronize", 130, 200)]
    trace = Trace([(n, s * 1000, e * 1000) for n, s, e in ops],
                  [(n, s * 1000, e * 1000) for n, s, e in host], (0, 400_000))
    shape = {"rows": 512, "particles": 8192, "planes": 3, "step_params": 2, "model": "ucsv",
             "carry": False}
    ctx = SimpleNamespace(trace=trace, shape=shape,
                          traced_calls=[(0, 0.0004, {"inner_steps": 2, "particle_steps": 0})])
    load = lambda name: catalog.load_module("metrics", name).read(ctx)  # noqa: E731
    assert load("graph_launches_per_inner_step") == 0.5
    assert abs(load("glue_us_per_inner_step") - 15.0) < 1e-9
    assert abs(load("device_idle_pct") - 100 * (1 - 240 / 400)) < 1e-9
    k1 = 4 * 512 * 8192 * 7 + 4 * 512
    assert abs(load("resample_roofline") - 100 * 2 * k1 / 3.35e12 / 120e-6) < 1e-9
    assert abs(load("inner_step_mfu") - 100 * 2 * (32 * 512 * 8192 / 3.35e12) / 400e-6) < 1e-9
    gaps = trace.idle_gaps()
    assert gaps == [("cudaStreamSynchronize", 70e-6), ("host, no call", 90e-6)]


def test_tiny_sizes_cover_every_cell():
    """Every cell has its file of CPU sizes, and every file is a cell's."""
    bench = catalog.benchmark()
    assert {w["name"] for w in bench["workloads"]} == set(cells())
    for cell in cells():
        assert set(sizes(cell)) >= {"params", "seconds", "limits", "short"}, cell
