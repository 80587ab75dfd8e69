"""Resample + ancestor gather of an (M, C, N) cloud (the function of
``chip_smoke.py::resample_cost``, frozen): the weights and the cloud read,
the cloud written, and the systematic scheme's offsets u0 (M) or the sorted
scheme's grid u (M, N) read. Operations: per slot a scan step, a divide and
a log2(N)-step search (these functions are bound by bytes)."""
from __future__ import annotations

import math


def nbytes(m: int, n: int, c: int, grid: bool = False) -> int:
    return 4 * m * n * (2 * c + 1 + (1 if grid else 0)) + (0 if grid else 4 * m)


def flops(m: int, n: int) -> float:
    return m * n * (math.log2(n) + 3)
