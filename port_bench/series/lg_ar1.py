"""``{"kind": "lg_ar1", "seed", "t", "theta": [A, Q, R]}``: x_1 ~ N(0, 1),
x_t = A x_t−1 + N(0, Q), y_t = x_t + N(0, R), drawn x then y at each t."""
import math

import numpy as np


def make(spec: dict, t: int) -> np.ndarray:
    rng = np.random.default_rng(spec["seed"])
    a, q, r = spec["theta"]
    x, y = rng.normal(0.0, 1.0), np.empty(t)
    for i in range(t):
        if i:
            x = a * x + rng.normal(0.0, math.sqrt(q))
        y[i] = x + rng.normal(0.0, math.sqrt(r))
    return y.astype(np.float32)
