"""Particle-filter configuration — ``PFConfig`` from
``sequential_monte_carlo_tpu/ops/particle_filter.py``. The per-θ filter
functions come with ROADMAP Queue 1 item 10."""
from __future__ import annotations

from typing import NamedTuple


class PFConfig(NamedTuple):
    """Static filter configuration. The JAX package's TPU routing fields
    (``fused_resample``, ``mesh``) have no counterpart: the port has one
    route per device."""

    resampling: str = "systematic"
    ess_threshold: float = 1.0  # resample when ESS < τ·N; 1.0 ≡ every step
    proposal: object = None  # guided-PF proposal; None = bootstrap
    algorithm: str = "bootstrap"  # or "apf"
