"""Everything a run needs, found by the names in ``BENCHMARK.json``."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module in ``<bench_dir>/<kind>/<name>.py`` (names may hold dots;
    ``kind`` may be a nested directory, such as ``reference/models``). Every
    part found by a name goes through here: entries, metrics, series kinds,
    prior kinds (``reference/prior_kinds``), reference models
    (``reference/models``) and step counts (``counts/models``)."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    package = "port_bench." + kind.replace("/", ".")
    spec = importlib.util.spec_from_file_location(f"{package}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(name: str, bench: dict, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell's entry in BENCHMARK.json (its configuration and traffic
    are named there alone) merged with its workload file and its
    configuration file (under ``"config_data"``)."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    (entry,) = entries
    data = _json(bench_dir / "workloads" / f"{name}.json")
    config = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(config) != 1:
        raise KeyError(f"configuration {entry['config']!r} is not in BENCHMARK.json")
    return {**entry, **data, "config_data": _json(bench_dir.parent / config[0]["file"])}


def metrics_for(bench: dict, name: str, trace: bool) -> list:
    """The metrics a cell reports: its end-to-end ones (trace off) or its
    per-layer ones (trace on), each listing the cell or listing none."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]
