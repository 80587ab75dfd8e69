"""Particle-filter configuration — ``PFConfig`` and ``Proposal`` from
``sequential_monte_carlo_tpu/ops/particle_filter.py``. The per-θ filter
functions come with ROADMAP Queue 1 item 10."""
from __future__ import annotations

from typing import Callable, NamedTuple


class Proposal(NamedTuple):
    """Guided-filter proposal: q0(model) and q(model, x_prev), each a
    distribution over the state. The batched filter calls them with the
    θ-cloud's model and states laid out (..., M, dx), as the models'
    own distribution methods take them."""

    initial: Callable  # model -> distribution over x_1
    step: Callable  # (model, x_prev (..., M, dx)) -> distribution over x_t


class PFConfig(NamedTuple):
    """Static filter configuration. The JAX package's TPU routing fields
    (``fused_resample``, ``mesh``) have no counterpart: the port has one
    route per device."""

    resampling: str = "systematic"
    ess_threshold: float = 1.0  # resample when ESS < τ·N; 1.0 ≡ every step
    proposal: object = None  # a Proposal for the guided filter; None = bootstrap
    algorithm: str = "bootstrap"  # or "apf"
