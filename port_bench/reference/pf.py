"""A bootstrap particle filter over a bank of θ rows, systematic
resampling at every step, in plain PyTorch and in any floating dtype.

Every number is computed in ``dtype``; the resample's cdf and the running
log Z are summed in float64 when ``dtype`` is float32 (the reference), and
in ``dtype`` itself below it (the control).
"""
from __future__ import annotations

import math

import torch


def acc_dtype(dtype):
    return torch.float64 if dtype == torch.float32 else dtype


def systematic_ancestors(generator, log_w, acc):
    """(M, N) ancestors of one systematic draw a row from normalized
    log-weights: the row's cdf searched at (u0 + i) / N."""
    m, n = log_w.shape
    cdf = torch.cumsum(torch.exp(log_w).to(acc), dim=1)
    cdf = cdf / cdf[:, -1:]
    u0 = torch.rand((m, 1), generator=generator, device=log_w.device, dtype=acc)
    pos = (u0 + torch.arange(n, device=log_w.device, dtype=acc)) / n
    return torch.searchsorted(cdf, pos).clamp_max(n - 1)


def _weigh(logw, log_z):
    """(normalized log-weights, log Z plus the step's log-mean)."""
    lse = torch.logsumexp(logw, dim=1)
    return logw - lse[:, None], log_z + (lse - math.log(logw.shape[1])).to(log_z.dtype)


def init(generator, model, theta, y0, n: int):
    """(cloud, normalized log-weights, log Z) after y0."""
    cloud = model.init(generator, theta, n)
    zero = torch.zeros(theta.shape[0], device=theta.device, dtype=acc_dtype(theta.dtype))
    log_w, log_z = _weigh(model.obs_log_prob(theta, cloud, y0), zero)
    return cloud, log_w, log_z


def step(generator, model, theta, cloud, log_w, log_z, yt):
    """Resample, propagate and reweight at yt: (cloud, log_w, log Z,
    the step's log-mean)."""
    anc = systematic_ancestors(generator, log_w, acc_dtype(cloud.dtype))
    cloud = torch.gather(cloud, 2, anc[:, None, :].expand(-1, cloud.shape[1], -1))
    cloud = model.step(generator, theta, cloud)
    new_w, new_z = _weigh(model.obs_log_prob(theta, cloud, yt), log_z)
    return cloud, new_w, new_z, new_z - log_z


def run(generator, model, theta, y, n: int, variance: bool = False):
    """The filter over all of y: (final cloud, final normalized log-weights,
    log Z) of every row; with ``variance``, also each row's estimate of its
    log Z's variance, Σ_t (1/ESS_t − 1/N) over the steps' weights (the
    first-order approximation of a bootstrap filter that resamples every
    step: a row whose weights collapse reads large)."""
    cloud, log_w, log_z = init(generator, model, theta, y[0], n)
    var = _var(log_w, n)
    for t in range(1, y.shape[0]):
        cloud, log_w, log_z, _ = step(generator, model, theta, cloud, log_w, log_z, y[t])
        if variance:
            var = var + _var(log_w, n)
    return (cloud, log_w, log_z, var) if variance else (cloud, log_w, log_z)


def _var(log_w, n: int):
    w = torch.exp(log_w.to(acc_dtype(log_w.dtype)))
    return torch.sum(w * w, dim=1) - 1.0 / n
