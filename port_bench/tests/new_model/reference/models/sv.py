"""The canonical stochastic-volatility model, θ = (mu, phi, sigma):

    x_1 ~ N(mu, sigma² / (1 − phi²)),  x_t = mu + phi (x_t−1 − mu) + sigma z,
    y_t ~ N(0, exp(x_t))

A cloud is (M, 1, N)."""
from __future__ import annotations

import math

import torch

PLANES = 1
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def init(generator, theta, n: int):
    z = torch.randn((theta.shape[0], 1, n), generator=generator, device=theta.device,
                    dtype=theta.dtype)
    mu, phi, sigma = (theta[:, j, None, None] for j in range(3))
    return mu + sigma / torch.sqrt(1.0 - phi * phi) * z


def step(generator, theta, cloud):
    z = torch.randn(cloud.shape, generator=generator, device=cloud.device, dtype=cloud.dtype)
    mu, phi, sigma = (theta[:, j, None, None] for j in range(3))
    return mu + phi * (cloud - mu) + sigma * z


def obs_log_prob(theta, cloud, y):
    x = cloud[:, 0]
    return -0.5 * y * y * torch.exp(-x) - 0.5 * x - _HALF_LOG_2PI
