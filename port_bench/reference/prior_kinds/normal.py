"""``["normal", loc, scale]``: N(loc, scale²)."""
import math

import torch

ARITY = 2
PROGRAM = "Normal"
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def sample(generator, m: int, device, p):
    z = torch.randn(m, generator=generator, device=device, dtype=torch.float64)
    return p[0] + p[1] * z


def in_support(x, p):
    return torch.ones_like(x, dtype=torch.bool)


def log_prob(x, p):
    z = (x - p[0]) / p[1]
    return -0.5 * z * z - math.log(p[1]) - _HALF_LOG_2PI
