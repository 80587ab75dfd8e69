"""Stock and Watson's unobserved-components model with stochastic
volatility (J. Money Credit Bank. 39(s1), 2007), as the 4-parameter θ =
(γ, x0, log σε0, log ση0) that the inflation example and bench.py fit:

    x_1 ~ N(x0, exp(½ log σε0)),  log σε,1 ~ N(log σε0, γ),  log ση,1 ~ N(log ση0, γ)
    x_t = x_{t−1} + exp(½ log σε,t−1) z0,  log σε,t = log σε,t−1 + γ z1,
    log ση,t = log ση,t−1 + γ z2,  y_t ~ N(x_t, exp(½ log ση,t))

(scales are standard deviations). A cloud is (M, 3, N): the planes x,
log σε, log ση for each row's N particles.
"""
from __future__ import annotations

import math

import torch

PLANES = 3
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _normals(generator, m: int, n: int, like):
    return torch.randn((m, PLANES, n), generator=generator, device=like.device, dtype=like.dtype)


def init(generator, theta, n: int):
    """(M, 3, N) draws from each row's initial distribution."""
    z = _normals(generator, theta.shape[0], n, theta)
    gamma, x0, lse0, lsn0 = (theta[:, j, None] for j in range(4))
    return torch.stack([x0 + torch.exp(0.5 * lse0) * z[:, 0],
                        lse0 + gamma * z[:, 1],
                        lsn0 + gamma * z[:, 2]], dim=1)


def step(generator, theta, cloud):
    """One draw from the transition of every particle."""
    z = _normals(generator, theta.shape[0], cloud.shape[2], cloud)
    gamma = theta[:, 0, None]
    x, lse, lsn = cloud[:, 0], cloud[:, 1], cloud[:, 2]
    return torch.stack([x + torch.exp(0.5 * lse) * z[:, 0],
                        lse + gamma * z[:, 1],
                        lsn + gamma * z[:, 2]], dim=1)


def obs_log_prob(theta, cloud, y):
    """(M, N) log N(y; x, exp(½ log ση))."""
    x, lsn = cloud[:, 0], cloud[:, 2]
    z = (y - x) * torch.exp(-0.5 * lsn)
    return -0.5 * z * z - 0.5 * lsn - _HALF_LOG_2PI
