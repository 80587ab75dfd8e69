"""``["uniform", low, high]``: U(low, high)."""
import math

import torch

ARITY = 2
PROGRAM = "Uniform"


def sample(generator, m: int, device, p):
    u = torch.rand(m, generator=generator, device=device, dtype=torch.float64)
    return p[0] + (p[1] - p[0]) * u


def in_support(x, p):
    return (x >= p[0]) & (x <= p[1])


def log_prob(x, p):
    return torch.full_like(x, -math.log(p[1] - p[0]))
