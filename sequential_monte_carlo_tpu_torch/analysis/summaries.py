"""Posterior summaries (L4) — counterpart of
``sequential_monte_carlo_tpu/analysis/summaries.py``: weighted quantiles,
means and variances of a particle cloud; the ω-averaged state and cycle
quantiles, trend and predictive quantiles of an SMC² state; the Gaussian
predictive of an IBIS state; histograms of θ-posterior draws.

Plain tensor code on the state's device, batched over the θ-cloud where the
JAX package maps over it, so that ``filter_sequence(summarize=)`` and
``SMC2.run(collect_fn=)`` can call them at every step; none reads the host,
so each can be captured inside ``filter_sequence``'s replayed step.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributions import Normal
from ..ops.smoothing import _categorical
from ..samplers.base import IBISState, SMC2State

__all__ = [
    "cycle_quantiles",
    "estimated_trend",
    "ibis_estimated_trend",
    "ibis_predictive_quantiles",
    "observation_dist",
    "posterior_histograms",
    "predictive_quantiles",
    "state_quantiles",
    "state_variance",
    "weighted_mean",
    "weighted_quantile",
    "weighted_quantile_binned",
    "weighted_var",
]


def _ps(ps, like: torch.Tensor) -> torch.Tensor:
    """The probabilities as a tensor on ``like``'s device. Python numbers
    are filled in on the device, not copied from host memory, so that a
    summary stays capturable inside ``filter_sequence``'s replayed step."""
    if isinstance(ps, (int, float)):
        return torch.full((), ps, dtype=like.dtype, device=like.device)
    if isinstance(ps, (list, tuple)) and all(isinstance(p, (int, float)) for p in ps):
        return torch.stack([torch.full((), p, dtype=like.dtype, device=like.device) for p in ps])
    return torch.as_tensor(ps, dtype=like.dtype, device=like.device)


def weighted_quantile(x, w, ps):
    """Inverse-CDF quantiles of the weighted sample (x, w) along the last
    axis (any leading batch axes): sort, cumulative weights normalized by
    their total, the first index whose cdf reaches p."""
    ps = _ps(ps, x)
    order = torch.argsort(x, dim=-1)
    xs = torch.gather(x, -1, order)
    cdf = torch.cumsum(torch.gather(w, -1, order), dim=-1)
    cdf = cdf / cdf[..., -1:]
    idx = torch.searchsorted(cdf, ps.expand(cdf.shape[:-1] + ps.shape).contiguous())
    return torch.gather(xs, -1, torch.clamp(idx, max=x.shape[-1] - 1))


def weighted_quantile_binned(x, w, ps, bins: int = 128):
    """Sort-free weighted quantiles from a histogram CDF on ``bins`` equal
    bins of each row's range, inverted at the bin edges and interpolated
    inside the landing bin (error at most one bin width). Leading batch axes
    on x and w; the quantiles ``ps`` (P,) on the trailing output axis. The
    bins' masses are a scatter-add (the JAX package's one-hot product) in
    fixed point: each weight in units of 2^-40 of its row's largest (rows
    of up to 2^23 particles), so that the card's atomic adds, in whatever
    order they land, give the same bits every run."""
    ps = _ps(ps, x)
    lo = torch.amin(x, dim=-1, keepdim=True)
    hi = torch.amax(x, dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    idx = torch.clamp(((x - lo) / span * bins).to(torch.int64), 0, bins - 1)
    w = w.expand(x.shape).to(x.dtype)
    top = torch.clamp(torch.amax(w, dim=-1, keepdim=True), min=torch.finfo(x.dtype).tiny)
    units = torch.round(w / top * 2.0**40).to(torch.int64)
    mass = torch.zeros(x.shape[:-1] + (bins,), dtype=torch.int64, device=x.device)
    mass = mass.scatter_add(-1, idx, units).to(x.dtype)
    cdf = torch.cumsum(mass, dim=-1)
    total = torch.clamp(cdf[..., -1:], min=1e-30)
    cdf = cdf / total
    # k(p): the first bin whose cdf reaches p
    k = torch.sum((cdf[..., :, None] < ps[..., None, :]).to(torch.int64), dim=-2)
    k = torch.clamp(k, 0, bins - 1)
    cdf_pad = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    cdf_lo = torch.gather(cdf_pad, -1, k)
    m_k = torch.gather(mass / total, -1, k)
    frac = torch.clamp((ps - cdf_lo) / torch.clamp(m_k, min=1e-12), 0.0, 1.0)
    return lo + (k.to(x.dtype) + frac) * (span / bins)


def weighted_mean(x, w):
    return torch.sum(w * x, dim=-1)


def weighted_var(x, w):
    mu = weighted_mean(x, w)
    return torch.sum(w * (x - mu[..., None]) ** 2, dim=-1)


# -- SMC² (particle-cloud) summaries ----------------------------------------

def _omega(state) -> torch.Tensor:
    return torch.softmax(state.log_omega, dim=0)


def _per_theta_quantiles(x, log_w, ps, method: str):
    if method == "binned":
        return weighted_quantile_binned(x, torch.exp(log_w), ps)
    return weighted_quantile(x, torch.exp(log_w), ps)


def state_quantiles(state: SMC2State, ps, component: int = 0, method: str = "binned"):
    """ω-average of each θ's weighted quantiles of one state component:
    ``method`` "binned" (sort-free, for per-step collection) or "sort"
    (exact inverse CDF)."""
    x = state.particles[..., component]
    return _omega(state) @ _per_theta_quantiles(x, state.log_w, ps, method)


def cycle_quantiles(state: SMC2State, yt, ps, component: int = 0, method: str = "binned"):
    """Quantiles of the cycle y_t − x_t, as :func:`state_quantiles`."""
    x = yt - state.particles[..., component]
    return _omega(state) @ _per_theta_quantiles(x, state.log_w, ps, method)


def state_variance(state: SMC2State, component: int = 0):
    """ω-average of each θ's weighted variance of a state component."""
    return _omega(state) @ weighted_var(state.particles[..., component], torch.exp(state.log_w))


def _mean_state(state: SMC2State):
    """Each θ's weighted-mean state x̄ (M, dx)."""
    return torch.einsum("mn,mnd->md", torch.exp(state.log_w), state.particles)


def estimated_trend(state: SMC2State, model_fn):
    """Σ_m ω_m · E[y | x̄_m, θ_m]: the observation mean at each θ's
    weighted-mean state."""
    return _omega(state) @ model_fn(state.theta).observation_distribution(
        _mean_state(state)).mean()


def predictive_quantiles(state: SMC2State, model_fn, ps):
    """ω-mixture of each θ's observation quantiles at its weighted-mean
    state, for the sorted ``ps``."""
    ps = torch.sort(_ps(ps, state.theta)).values
    obs = model_fn(state.theta).observation_distribution(_mean_state(state))
    return _omega(state) @ obs.quantile(ps[:, None]).T


# -- IBIS (exact-Gaussian) summaries ----------------------------------------

def observation_dist(state: IBISState, model_fn):
    """ω-weighted moment-matched predictive (ȳ, Σ̄) from the Kalman states."""
    m = model_fn(state.theta)
    ys = torch.sum(m.B * state.mean, dim=-1)
    ss = torch.einsum("mi,mij,mj->m", m.B, state.cov, m.B) + m.R
    omega = _omega(state)
    return omega @ ys, omega @ ss


def ibis_estimated_trend(state: IBISState, model_fn):
    return observation_dist(state, model_fn)[0]


def ibis_predictive_quantiles(state: IBISState, model_fn, ps):
    """Gaussian quantiles of the IBIS predictive, for the sorted ``ps``."""
    y, s = observation_dist(state, model_fn)
    return Normal(y, torch.sqrt(s)).quantile(torch.sort(_ps(ps, y)).values)


# -- θ-posterior histograms --------------------------------------------------

def posterior_histograms(generator, state, n_samples: int = 10_000, bins: int = 50):
    """``n_samples`` θ drawn from the cloud's weights ω (from ``generator``)
    → per-dimension histograms: a list of (counts, edges) numpy pairs."""
    idx = _categorical(generator, state.log_omega, n_samples)
    draws = state.theta[idx].cpu().numpy()
    return [np.histogram(draws[:, i], bins=bins) for i in range(draws.shape[1])]
