"""Observation series from a configuration's ``series`` parameters, one
general generator a kind, NumPy from a fixed seed (float32 out)."""
from __future__ import annotations

import math

import numpy as np


def make(spec: dict, t: int | None = None) -> np.ndarray:
    """``{"kind": "random_walk_plus_noise", "seed", "t", "level", "walk_sd",
    "noise_sd"}``: level + cumsum(N(0, walk_sd)) + N(0, noise_sd), the walk's
    draws first (bench.py's inflation-like series). ``{"kind": "lg_ar1",
    "seed", "t", "theta": [A, Q, R]}``: x_1 ~ N(0, 1), x_t = A x_t−1 +
    N(0, Q), y_t = x_t + N(0, R), drawn x then y at each t. ``t`` overrides
    the length."""
    t = int(spec["t"] if t is None else t)
    rng = np.random.default_rng(spec["seed"])
    if spec["kind"] == "random_walk_plus_noise":
        y = (spec["level"] + np.cumsum(rng.normal(0, spec["walk_sd"], t))
             + rng.normal(0, spec["noise_sd"], t))
    elif spec["kind"] == "lg_ar1":
        a, q, r = spec["theta"]
        x, y = rng.normal(0.0, 1.0), np.empty(t)
        for i in range(t):
            if i:
                x = a * x + rng.normal(0.0, math.sqrt(q))
            y[i] = x + rng.normal(0.0, math.sqrt(r))
    else:
        raise ValueError(f"unknown series kind {spec['kind']!r}")
    return y.astype(np.float32)
