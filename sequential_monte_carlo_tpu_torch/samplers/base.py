"""Sampler state and configuration (L3) — counterpart of
``sequential_monte_carlo_tpu/samplers/base.py`` for SMC² and IBIS."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.particle_filter import PFConfig
from ..utils.struct import struct


class SMCConfig(NamedTuple):
    """Static sampler configuration ≡ the JAX ``SMCConfig``."""

    n_particles: int = 1024  # N: state particles per θ
    n_theta: int = 512  # M: θ-particles
    chain: int = 3  # MCMC steps per rejuvenation
    ess_threshold: float = 0.5  # θ-ESS trigger: ess_min = M·threshold
    acc_threshold: float = -1.0  # exchange trigger (min_ar; -1 disables)
    # the exchange step's padding policy (acc_threshold > 0):
    #   "grow": arrays stay at the live size; a doubling that fires raises
    #           state.exchange_pending, serviced after the step
    #           (maybe_exchange, run_segmented) by re-padding to 2N and
    #           refiltering;
    #   "full": arrays padded once to the doubling cap; active_n doubles
    #           right after the rejuvenation, inside the step, and every
    #           step runs at the padded shape.
    elastic_pad: str = "grow"
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
    # exchange step: double N while N ≤ this
    exchange_max_n: int = 4096

    @property
    def ess_min(self) -> float:
        return self.n_theta * self.ess_threshold


@struct
class SMC2State:
    """θ-cloud + per-θ particle clouds. The JAX state's PRNG key is a
    ``torch.Generator`` passed to each call instead, and ``t``, ``active_n``
    and ``exchange_pending`` are host values."""

    theta: torch.Tensor  # (M, dθ)
    log_omega: torch.Tensor  # (M,) unnormalized θ log-weights
    # the clouds: under θ-sharding this rank's M/R rows, and under particle
    # sharding its N/Rp particles of each
    particles: torch.Tensor  # (M, N, dx), planar storage
    log_w: torch.Tensor  # (M, N) normalized per-θ particle log-weights
    log_z: torch.Tensor  # (M,) running per-θ marginal-likelihood estimate
    ess: torch.Tensor  # scalar θ-ESS
    acc_ratio: torch.Tensor  # scalar: last rejuvenation acceptance rate
    t: int  # number of observations assimilated
    # live state particles per θ: the array size, but under the exchange
    # step's "full" padding, where slots ≥ active_n hold log_w = −inf
    active_n: int
    # an exchange fired in "grow" mode and waits for its doubling
    exchange_pending: bool

    @property
    def n_theta(self) -> int:
        return self.theta.shape[0]

    @property
    def n_particles(self) -> int:
        return self.particles.shape[1]


@struct
class IBISState:
    """θ-cloud with the per-θ exact Kalman states ≡ the JAX ``IBISState``,
    with ``t`` a host int and no PRNG key."""

    theta: torch.Tensor  # (M, dθ)
    log_omega: torch.Tensor  # (M,)
    # the Kalman bank: under θ-sharding this rank's M/R rows
    mean: torch.Tensor  # (M, dx) Kalman filtered means
    cov: torch.Tensor  # (M, dx, dx) Kalman filtered covariances
    log_z: torch.Tensor  # (M,)
    ess: torch.Tensor
    acc_ratio: torch.Tensor
    t: int

    @property
    def n_theta(self) -> int:
        return self.theta.shape[0]


class StepInfo(NamedTuple):
    """Per-step telemetry (stacked over steps by ``SMC2.run``)."""

    ess: torch.Tensor
    rejuvenated: torch.Tensor  # bool: degeneracy branch taken
    acc_ratio: torch.Tensor  # acceptance rate of the last rejuvenation
    log_evidence_incr: torch.Tensor  # log p̂(y_t | y_{1:t-1})
