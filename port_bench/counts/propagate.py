"""Propagate + reweight (+ normalize) of an (M, S, N) cloud (the function
of ``chip_smoke.py::propagate_cost``, frozen): the S state planes (and the
carried log-weights) read, the new planes and the log-weights written, P
parameters a row read and, normalized, the row's lse and ESS written.

Operations per particle, counting a transcendental as one: a normal by
Box–Muller 6 (log, sqrt, sin or cos, three products), the model's update
(``NORMALS`` normals and ``UPDATE_OPS`` operations, from the model's
``counts/models/<model>.py``, found by the configuration's ``model``), the
normalize 7."""
from __future__ import annotations

from port_bench.harness import catalog

BOX_MULLER, NORMALIZE = 6, 7


def nbytes(m: int, n: int, s: int, p: int, carry: bool = False, normalize: bool = True) -> int:
    return 4 * m * n * (2 * s + 1 + (1 if carry else 0)) + 4 * m * (p + (2 if normalize else 0))


def flops(m: int, n: int, model: str, normalize: bool = True) -> float:
    counts = catalog.load_module("counts/models", model)
    return m * n * (counts.NORMALS * BOX_MULLER + counts.UPDATE_OPS
                    + (NORMALIZE if normalize else 0))
