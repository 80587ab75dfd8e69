"""``["truncated_normal", loc, scale, low, high]``: N(loc, scale²) cut to
[low, high], drawn by the inverse cdf between the bounds' probabilities."""
import math

import torch

ARITY = 4
PROGRAM = "TruncatedNormal"
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _ndtr(x: float) -> float:
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


def sample(generator, m: int, device, p):
    loc, scale, low, high = p
    a, b = _ndtr((low - loc) / scale), _ndtr((high - loc) / scale)
    u = torch.rand(m, generator=generator, device=device, dtype=torch.float64)
    q = a + (b - a) * u
    return (loc + scale * torch.special.ndtri(q)).clamp(low, high)


def in_support(x, p):
    return (x >= p[2]) & (x <= p[3])


def log_prob(x, p):
    loc, scale, low, high = p
    mass = _ndtr((high - loc) / scale) - _ndtr((low - loc) / scale)
    z = (x - loc) / scale
    return -0.5 * z * z - math.log(scale) - _HALF_LOG_2PI - math.log(mass)
