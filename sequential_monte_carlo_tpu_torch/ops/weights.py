"""Log-weight normalization and effective-sample-size math — counterpart of
``sequential_monte_carlo_tpu/ops/weights.py``: ``normalize`` (and its alias
``reweight``) to linear weights, ``log_normalize`` in log space,
``ess_from_log_weights``, and ``normalize_sharded`` over a particle axis
split across the ranks of a process group."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .sharding import all_reduce


class Normalized(NamedTuple):
    log_mean: torch.Tensor  # log of the mean unnormalized weight (per batch row)
    weights: torch.Tensor  # normalized linear weights, the input's shape
    ess: torch.Tensor  # effective sample size in [1, N]


def normalize(log_w: torch.Tensor, dim: int = -1) -> Normalized:
    """Normalize log-weights along ``dim`` (batched along the others) to
    linear weights: log_mean = max + log Σ exp(w − max) − log N, the weights
    exp(w − max)/Σ, ess = 1/Σ w²."""
    n = log_w.shape[dim]
    maxw = torch.amax(log_w, dim=dim, keepdim=True)
    maxw = torch.where(torch.isfinite(maxw), maxw, 0.0)  # an all −inf row
    w = torch.exp(log_w - maxw)
    sumw = torch.sum(w, dim=dim, keepdim=True)
    log_mean = torch.squeeze(maxw, dim) + torch.log(torch.squeeze(sumw, dim)) - math.log(n)
    w = w / sumw
    return Normalized(log_mean, w, 1.0 / torch.sum(w * w, dim=dim))


# the reference's name for the same operation at the sampler layer
reweight = normalize


def log_normalize(log_w: torch.Tensor, dim: int = -1, log_n: float | None = None, out=None):
    """Return (log_mean, normalized log-weights, ess) along ``dim``:
    log_mean = max + log Σ exp(w − max) − log N, ess = 1 / Σ w². ``log_n``
    replaces log N (the elastic filter's log active_n, or 0 where the
    weights already carry the 1/N). ``out``: a tensor that the normalized
    log-weights are written into."""
    if log_n is None:
        log_n = math.log(log_w.shape[dim])
    maxw = torch.amax(log_w, dim=dim, keepdim=True)
    maxw = torch.where(torch.isfinite(maxw), maxw, 0.0)
    shifted = log_w - maxw
    lse = torch.log(torch.sum(torch.exp(shifted), dim=dim, keepdim=True))
    log_norm = torch.sub(shifted, lse, out=out)
    log_mean = torch.squeeze(maxw + lse, dim) - log_n
    ess = 1.0 / torch.sum(torch.exp(2.0 * log_norm), dim=dim)
    return log_mean, log_norm, ess


def ess_from_log_weights(log_w: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """ESS = 1/Σw² of the normalized weights, computed in log space."""
    lw = log_w - torch.logsumexp(log_w, dim=dim, keepdim=True)
    return 1.0 / torch.sum(torch.exp(2.0 * lw), dim=dim)


def normalize_sharded(log_w: torch.Tensor, group=None) -> Normalized:
    """``normalize`` of a particle axis split over the ranks of ``group``
    (the default group when None): each rank holds a slice of it in its
    trailing dim, and the max and the sums ride ``all_reduce``. The total
    particle count is local N × the group's size."""
    n = log_w.shape[-1] * torch.distributed.get_world_size(group)
    maxw = all_reduce(torch.amax(log_w, dim=-1, keepdim=True), "max", group)
    maxw = torch.where(torch.isfinite(maxw), maxw, 0.0)
    w = torch.exp(log_w - maxw)
    sumw = all_reduce(torch.sum(w, dim=-1, keepdim=True), "sum", group)
    log_mean = torch.squeeze(maxw, -1) + torch.log(torch.squeeze(sumw, -1)) - math.log(n)
    w = w / sumw
    ess = 1.0 / all_reduce(torch.sum(w * w, dim=-1), "sum", group)
    return Normalized(log_mean, w, ess)
