"""One whole inner step of a bank of filters, whatever kernels compute it:
the cloud (S planes) and the log-weights read once and written once, and
the operations of the resample and of the propagate function. It stays the
same yardstick when a kernel is fused or removed."""
from __future__ import annotations

from . import propagate, resample


def nbytes(m: int, n: int, s: int) -> int:
    return 2 * 4 * m * n * (s + 1)


def flops(m: int, n: int, model: str) -> float:
    return resample.flops(m, n) + propagate.flops(m, n, model)
