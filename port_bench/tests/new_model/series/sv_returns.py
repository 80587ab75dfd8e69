"""``{"kind": "sv_returns", "seed", "t", "theta": [mu, phi, sigma]}``:
returns of the canonical stochastic-volatility model at a fixed θ: x_1 ~
N(mu, sigma² / (1 − phi²)), x_t = mu + phi (x_t−1 − mu) + sigma z, y_t =
exp(x_t / 2) ε, drawn x then ε at each t."""
import math

import numpy as np


def make(spec: dict, t: int) -> np.ndarray:
    rng = np.random.default_rng(spec["seed"])
    mu, phi, sigma = spec["theta"]
    x, y = mu + sigma / math.sqrt(1.0 - phi * phi) * rng.normal(), np.empty(t)
    for i in range(t):
        if i:
            x = mu + phi * (x - mu) + sigma * rng.normal()
        y[i] = math.exp(0.5 * x) * rng.normal()
    return y.astype(np.float32)
