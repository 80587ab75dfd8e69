"""Adaptive random-walk Metropolis kernel for θ-rejuvenation (L3) —
counterpart of ``sequential_monte_carlo_tpu/samplers/kernels.py``: a scaled
empirical-covariance RW proposal with a degenerate-covariance floor, jitter
and per-chain-step annealing of the proposal covariance. The (M, dθ)
products are plain ``torch`` ops."""
from __future__ import annotations

import math

import torch

from .base import SMCConfig


def empirical_cov(theta: torch.Tensor) -> torch.Tensor:
    """Unweighted sample covariance (divide by M − 1) of the θ-cloud."""
    m = theta.shape[0]
    centered = theta - torch.mean(theta, dim=0, keepdim=True)
    return (centered.T @ centered) / (m - 1)


def rw_kernel_cov(theta: torch.Tensor, config: SMCConfig) -> torch.Tensor:
    """The kernel covariance Σ with floor and jitter."""
    d = theta.shape[-1]
    cov = empirical_cov(theta)
    scale = config.rw_scale / d if d > 1 else config.rw_scale
    eye = torch.eye(d, dtype=theta.dtype, device=theta.device)
    degenerate = torch.linalg.norm(cov) < config.cov_floor_norm
    return torch.where(degenerate, config.cov_floor_value * eye,
                       scale * cov + config.cov_jitter * eye)


def anneal_scales(config: SMCConfig) -> list[float]:
    """Proposal-covariance multipliers per chain step: 0.5·reverse(1:chain),
    e.g. chain=3 ⇒ [1.5, 1.0, 0.5]."""
    return [config.anneal_base * k for k in range(config.chain, 0, -1)]


def propose(generator, theta: torch.Tensor, chol_sigma: torch.Tensor,
            scale: float) -> torch.Tensor:
    """θ' = θ + √scale · L ε for the whole cloud, Σ = L Lᵀ."""
    eps = torch.randn(theta.shape, generator=generator, device=theta.device,
                      dtype=theta.dtype)
    return theta + math.sqrt(scale) * (eps @ chol_sigma.T)


def kernel_chol(sigma: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of the (floored, jittered) kernel covariance. Where
    the factorization fails (a θ-cloud collapsed onto a few points in f32),
    the factor's lower triangle is NaN, as JAX's: every proposal then leaves
    the support and the move is rejected, where an exception would end the
    run."""
    L, info = torch.linalg.cholesky_ex(sigma)
    return torch.where(info == 0, L, torch.nan).tril()
