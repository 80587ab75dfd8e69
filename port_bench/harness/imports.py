"""What a run may not hold: JAX, or the JAX package beside the port."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sequential_monte_carlo_tpu")


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``sequential_monte_carlo_tpu_torch`` is not
    ``sequential_monte_carlo_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
