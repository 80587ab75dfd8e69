"""The univariate linear-Gaussian AR(1) of the reference README, θ = (A, Q,
R) with B = 1, x0 = 0 and Σ0 = 1 (Q, R and Σ0 variances):

    x_1 ~ N(0, 1),  x_t = A x_{t−1} + √Q z,  y_t ~ N(x_t, R)

A cloud is (M, 1, N). :func:`kalman_log_z` is the exact log-likelihood, in
float64 NumPy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PLANES = 1
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def init(generator, theta, n: int):
    return torch.randn((theta.shape[0], 1, n), generator=generator, device=theta.device,
                       dtype=theta.dtype)


def step(generator, theta, cloud):
    z = torch.randn(cloud.shape, generator=generator, device=cloud.device, dtype=cloud.dtype)
    return theta[:, 0, None, None] * cloud + torch.sqrt(theta[:, 1, None, None]) * z


def obs_log_prob(theta, cloud, y):
    r = theta[:, 2, None]
    d = y - cloud[:, 0]
    return -0.5 * d * d / r - 0.5 * torch.log(r) - _HALF_LOG_2PI


def kalman_log_z(theta, y) -> np.ndarray:
    """(M,) exact log p(y | θ) of each row, float64."""
    theta = np.asarray(theta, dtype=np.float64)
    a, q, r = theta[:, 0], theta[:, 1], theta[:, 2]
    mean, var = np.zeros(len(theta)), np.ones(len(theta))
    total = np.zeros(len(theta))
    for t, yt in enumerate(np.asarray(y, dtype=np.float64)):
        if t:
            mean, var = a * mean, a * a * var + q
        s = var + r
        total += -0.5 * (yt - mean) ** 2 / s - 0.5 * np.log(s) - _HALF_LOG_2PI
        k = var / s
        mean, var = mean + k * (yt - mean), (1.0 - k) * var
    return total
