"""``["lognormal", mu, sigma]``: exp(N(mu, sigma²))."""
import math

import torch

ARITY = 2
PROGRAM = "LogNormal"
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def sample(generator, m: int, device, p):
    z = torch.randn(m, generator=generator, device=device, dtype=torch.float64)
    return torch.exp(p[0] + p[1] * z)


def in_support(x, p):
    return x > 0


def log_prob(x, p):
    lx = torch.log(x.clamp_min(1e-30))
    z = (lx - p[0]) / p[1]
    return -0.5 * z * z - math.log(p[1]) - _HALF_LOG_2PI - lx
