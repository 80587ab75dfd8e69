"""Sampler state and configuration (L3) — counterpart of
``sequential_monte_carlo_tpu/samplers/base.py`` for SMC²."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.particle_filter import PFConfig
from ..utils.struct import struct


class SMCConfig(NamedTuple):
    """Static sampler configuration ≡ the JAX ``SMCConfig``, less the fields
    of what the port does not run yet: the exchange step's padding policy
    and cap (ROADMAP Queue 1 item 8). ``acc_threshold > 0`` (exchange on) is
    refused by ``SMC2``."""

    n_particles: int = 1024  # N: state particles per θ
    n_theta: int = 512  # M: θ-particles
    chain: int = 3  # MCMC steps per rejuvenation
    ess_threshold: float = 0.5  # θ-ESS trigger: ess_min = M·threshold
    acc_threshold: float = -1.0  # exchange trigger (min_ar; -1 disables)
    inner: PFConfig = PFConfig("systematic", 1.0)  # inner-PF config
    theta_resampling: str = "multinomial"
    # adaptive random-walk kernel constants
    rw_scale: float = 2.83**2
    cov_floor_norm: float = 1e-8
    cov_floor_value: float = 1e-2
    cov_jitter: float = 1e-10
    # rejuvenation proposal-scale annealing: 0.5·reverse(1:chain)
    anneal_base: float = 0.5
    # density-tempered bisection for the next temper ξ
    bisection_tol: float = 1e-6
    bisection_upper: float = 2.0

    @property
    def ess_min(self) -> float:
        return self.n_theta * self.ess_threshold


@struct
class SMC2State:
    """θ-cloud + per-θ particle clouds. The JAX state's PRNG key is a
    ``torch.Generator`` passed to each call instead, and ``t`` is a host int."""

    theta: torch.Tensor  # (M, dθ)
    log_omega: torch.Tensor  # (M,) unnormalized θ log-weights
    particles: torch.Tensor  # (M, N, dx), planar storage
    log_w: torch.Tensor  # (M, N) normalized per-θ particle log-weights
    log_z: torch.Tensor  # (M,) running per-θ marginal-likelihood estimate
    ess: torch.Tensor  # scalar θ-ESS
    acc_ratio: torch.Tensor  # scalar: last rejuvenation acceptance rate
    t: int  # number of observations assimilated


class StepInfo(NamedTuple):
    """Per-step telemetry (stacked over steps by ``SMC2.run``)."""

    ess: torch.Tensor
    rejuvenated: torch.Tensor  # bool: degeneracy branch taken
    acc_ratio: torch.Tensor  # acceptance rate of the last rejuvenation
    log_evidence_incr: torch.Tensor  # log p̂(y_t | y_{1:t-1})
