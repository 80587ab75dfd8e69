"""Small sizes at which the CPU tests drive whole runs of the cells (the
program's plain versions of its kernels run there), one file a cell:
``cells/<cell>.json`` holds the ``params`` that override the workload's,
the window's ``seconds``, the ``limits`` at those sizes, the overrides of
the inner faults' and the control's runs (``short``), a shorter series
where every step would rejuvenate, and the ``readings`` the limits were
set from."""
import json
import time
from pathlib import Path

from port_bench.harness import catalog, cli

CELLS = Path(__file__).resolve().parent / "cells"


def cells() -> list:
    """The cells that have a file of CPU sizes."""
    return sorted(p.stem for p in CELLS.glob("*.json"))


def sizes(name: str) -> dict:
    with open(CELLS / f"{name}.json") as f:
        return json.load(f)


def entry(name: str) -> str:
    """The entry point the cell's workload drives."""
    return catalog.cell(name, catalog.benchmark())["entry"]


def run(name, seed=2**31 + 11, seconds=None, program="program", overrides=None, **kw):
    s = sizes(name)
    return cli.run_cell(name, seed, seconds or s["seconds"], False, "cpu", time.perf_counter(),
                        overrides={**s["params"], **(overrides or {})}, program=program,
                        limits=s["limits"], **kw)
