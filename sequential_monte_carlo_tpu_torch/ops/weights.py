"""Log-weight normalization and effective-sample-size math — the slice's
subset of ``sequential_monte_carlo_tpu/ops/weights.py``."""
from __future__ import annotations

import math

import torch


def log_normalize(log_w: torch.Tensor, dim: int = -1):
    """Return (log_mean, normalized log-weights, ess) along ``dim``:
    log_mean = max + log Σ exp(w − max) − log N, ess = 1 / Σ w²."""
    n = log_w.shape[dim]
    maxw = torch.amax(log_w, dim=dim, keepdim=True)
    maxw = torch.where(torch.isfinite(maxw), maxw, 0.0)
    shifted = log_w - maxw
    lse = torch.log(torch.sum(torch.exp(shifted), dim=dim, keepdim=True))
    log_norm = shifted - lse
    log_mean = torch.squeeze(maxw + lse, dim) - math.log(n)
    ess = 1.0 / torch.sum(torch.exp(2.0 * log_norm), dim=dim)
    return log_mean, log_norm, ess


def ess_from_log_weights(log_w: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """ESS = 1/Σw² of the normalized weights, computed in log space."""
    lw = log_w - torch.logsumexp(log_w, dim=dim, keepdim=True)
    return 1.0 / torch.sum(torch.exp(2.0 * lw), dim=dim)
