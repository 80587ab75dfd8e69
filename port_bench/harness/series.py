"""Observation series from a configuration's ``series`` parameters: the
generator of its kind, ``port_bench/series/<kind>.py``, found by name."""
from __future__ import annotations

import numpy as np

from . import catalog


def make(spec: dict, t: int | None = None) -> np.ndarray:
    """The series of ``spec`` (its ``kind``, its fixed ``seed``, its
    parameters), float32, of length ``spec["t"]`` or ``t`` where given."""
    t = int(spec["t"] if t is None else t)
    y = catalog.load_module("series", spec["kind"]).make(spec, t)
    if not isinstance(y, np.ndarray) or y.dtype != np.float32 or y.shape != (t,):
        raise ValueError(f"series kind {spec['kind']!r} made {type(y).__name__} "
                         f"{getattr(y, 'dtype', None)} {getattr(y, 'shape', None)}, "
                         f"not float32 ({t},)")
    return y
