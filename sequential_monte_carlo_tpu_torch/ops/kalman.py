"""Exact Kalman filter for linear-Gaussian models (L2 oracle) — counterpart
of ``sequential_monte_carlo_tpu/ops/kalman.py``, batched over the model's
leading axes (a θ-cloud's M filters run as one).

Per step, from the filtered (x, P) — the first from (x0, Σ0):

  x̂ = A x,  P̂ = A P Aᵀ + Q
  s  = B P̂ Bᵀ + R,  Δ = y − B x̂
  x' = x̂ + P̂ Bᵀ s⁻¹ Δ,  P' = P̂ − P̂ Bᵀ s⁻¹ B P̂
  ℓ  = −½ (log 2π + log s + Δ²/s)

The univariate observation makes every inversion a scalar divide.

The loops over t (:func:`kalman_filter`, :func:`kalman_log_likelihood`,
:func:`kalman_log_likelihood_masked`, and IBIS's rejuvenations through
:func:`live_log_likelihood`) are the JAX package's ``lax.scan``\\ s: on a
CUDA device, outside ``disable_graphs()`` and without a mesh
(``batched_filter.captures``' rule), they replay CUDA graphs of
``graphs.STEPS_PER_GRAPH`` steps and of one (``ops/graphs.py::kalman_route``),
bit for bit the eager loop here, which runs inside ``disable_graphs()`` and
on the CPU. Neither reads the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import batched_filter as _bf
from . import graphs

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


def masked_step(model, mean, cov, y, live=None):
    """One step of the loops: (mean, cov, ℓ) after y, or with ``live`` (a
    0-dim bool tensor) where it is False the step is the identity and ℓ is
    0 (JAX's per-step ``jnp.where``)."""
    out = kalman_step(model, KalmanState(mean, cov), y)
    if live is None:
        return out.state.mean, out.state.cov, out.log_lik
    return (torch.where(live, out.state.mean, mean), torch.where(live, out.state.cov, cov),
            torch.where(live, out.log_lik, 0.0))


def _captured(device) -> bool:
    """Whether the Kalman loops replay on ``device`` (``captures``' rule)."""
    return _bf.captures(_bf.PFConfig(), None, device)


def _loop(model, y, steps: int, mask=None, store: bool = False):
    """The eager loop over y[0:steps] from (x0, Σ0): ((mean, cov), log Z),
    and with ``store`` the per-step (means, covs, ℓ) lists."""
    mean, cov = kalman_init(model)
    logz = torch.zeros(model.R.shape, dtype=y.dtype, device=y.device)
    means, covs, lls = [], [], []
    for t in range(steps):
        live = None if mask is None else mask[t] > 0
        mean, cov, ll = masked_step(model, mean, cov, y[t], live)
        logz = logz + ll
        if store:
            means.append(mean)
            covs.append(cov)
            lls.append(ll)
    return KalmanState(mean, cov), logz, (means, covs, lls)


def kalman_filter(model, y):
    """Filter the whole sequence y (T,): returns (means (T, ..., dx),
    covs (T, ..., dx, dx), per-step log-likelihoods (T, ...), log Z)."""
    if _captured(y.device):
        means, covs, logliks = graphs.kalman_stored(model, y)
    else:
        _, _, (means, covs, logliks) = _loop(model, y, y.shape[0], store=True)
        means, covs, logliks = torch.stack(means), torch.stack(covs), torch.stack(logliks)
    return means, covs, logliks, torch.sum(logliks, dim=0)


def live_log_likelihood(model, y, live: int, graphed: bool, mesh=None):
    """The final (mean, cov) and log Z over the first ``live`` observations
    (a host int: IBIS's t), replayed where ``graphed`` (⌊live/S⌋ launches
    of the S-step graph, then one a step; ``mesh``, where the bank is a
    rank's rows, keys the route), else the eager loop."""
    if graphed:
        return graphs.kalman_live(model, y, live, mesh)
    state, logz, _ = _loop(model, y, live)
    return state, logz


def kalman_log_likelihood(model, y):
    """Returns the final (mean, cov) and log Z of y (T,)."""
    return live_log_likelihood(model, y, y.shape[0], _captured(y.device))


def kalman_log_likelihood_masked(model, y, mask):
    """As :func:`kalman_log_likelihood`, over the steps with mask > 0 only:
    all T steps run, and where mask ≤ 0 a step is the identity with ℓ = 0
    (JAX's per-step ``jnp.where``), so the mask, on the device or not, is
    never read on the host."""
    mask = torch.as_tensor(mask)
    if mask.device != y.device:
        # pinned, so the copy does not wait for the device
        mask = (mask.pin_memory() if y.is_cuda else mask).to(y.device, non_blocking=True)
    if _captured(y.device):
        return graphs.kalman_masked(model, y, mask)
    state, logz, _ = _loop(model, y, y.shape[0], mask)
    return state, logz
