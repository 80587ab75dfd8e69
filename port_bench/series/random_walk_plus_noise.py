"""``{"kind": "random_walk_plus_noise", "seed", "t", "level", "walk_sd",
"noise_sd"}``: level + cumsum(N(0, walk_sd)) + N(0, noise_sd), the walk's
draws first (bench.py's inflation-like series)."""
import numpy as np


def make(spec: dict, t: int) -> np.ndarray:
    rng = np.random.default_rng(spec["seed"])
    y = (spec["level"] + np.cumsum(rng.normal(0, spec["walk_sd"], t))
         + rng.normal(0, spec["noise_sd"], t))
    return y.astype(np.float32)
