"""Exact Kalman filter for linear-Gaussian models (L2 oracle) — counterpart
of ``sequential_monte_carlo_tpu/ops/kalman.py``, batched over the model's
leading axes (a θ-cloud's M filters run as one).

Per step, from the filtered (x, P) — the first from (x0, Σ0):

  x̂ = A x,  P̂ = A P Aᵀ + Q
  s  = B P̂ Bᵀ + R,  Δ = y − B x̂
  x' = x̂ + P̂ Bᵀ s⁻¹ Δ,  P' = P̂ − P̂ Bᵀ s⁻¹ B P̂
  ℓ  = −½ (log 2π + log s + Δ²/s)

The univariate observation makes every inversion a scalar divide.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class KalmanState(NamedTuple):
    mean: torch.Tensor  # (..., dx)
    cov: torch.Tensor  # (..., dx, dx)


class KalmanStep(NamedTuple):
    state: KalmanState
    log_lik: torch.Tensor  # (...) log p(y_t | y_{1:t-1})
    predicted: KalmanState  # one-step-ahead (x̂, P̂)


def kalman_init(model) -> KalmanState:
    """The prior state before any data, (x0, Σ0)."""
    return KalmanState(model.x0, model.sigma0)


def kalman_step(model, state: KalmanState, y) -> KalmanStep:
    """One predict / update / likelihood step."""
    A, B, Q, R = model.A, model.B, model.Q, model.R
    x, P = state
    x = (A @ x[..., None])[..., 0]
    P = A @ P @ A.mT + Q
    predicted = KalmanState(x, P)
    PBt = (P @ B[..., None])[..., 0]
    s = torch.sum(B * PBt, dim=-1) + R
    delta = y - torch.sum(B * x, dim=-1)
    gain = PBt / s[..., None]
    x = x + gain * delta[..., None]
    P = P - gain[..., :, None] * PBt[..., None, :]
    log_lik = -0.5 * (_LOG_2PI + torch.log(s) + delta * delta / s)
    return KalmanStep(KalmanState(x, P), log_lik, predicted)


def kalman_filter(model, y):
    """Filter the whole sequence y (T,): returns (means (T, ..., dx),
    covs (T, ..., dx, dx), per-step log-likelihoods (T, ...), log Z)."""
    state, means, covs, logliks = kalman_init(model), [], [], []
    for t in range(y.shape[0]):
        out = kalman_step(model, state, y[t])
        state = out.state
        means.append(state.mean)
        covs.append(state.cov)
        logliks.append(out.log_lik)
    logliks = torch.stack(logliks)
    return torch.stack(means), torch.stack(covs), logliks, torch.sum(logliks, dim=0)


def kalman_log_likelihood(model, y):
    """Returns the final (mean, cov) and log Z of y (T,)."""
    return kalman_log_likelihood_masked(model, y, torch.ones_like(y))


def kalman_log_likelihood_masked(model, y, mask):
    """As :func:`kalman_log_likelihood`, over the steps with mask > 0 only
    (the others are the identity). ``mask`` is read on the host."""
    state = kalman_init(model)
    logz = torch.zeros(model.R.shape, dtype=y.dtype, device=y.device)
    for t in torch.nonzero(torch.as_tensor(mask).cpu() > 0).flatten().tolist():
        out = kalman_step(model, state, y[t])
        state, logz = out.state, logz + out.log_lik
    return state, logz
