"""``["beta", a, b, low, high]``: Beta(a, b) scaled to (low, high), drawn as
G_a / (G_a + G_b) from one call for both gammas (the prior of an AR
coefficient on (−1, 1), Kim, Shephard and Chib 1998). The port has no Beta:
a cell whose program draws its own prior cannot take this kind."""
import math

import torch

ARITY = 4
PROGRAM = None


def sample(generator, m: int, device, p):
    a, b, low, high = p
    alpha = torch.cat([torch.full((m,), a, device=device, dtype=torch.float64),
                       torch.full((m,), b, device=device, dtype=torch.float64)])
    g = torch._standard_gamma(alpha, generator=generator)
    return low + (high - low) * g[:m] / (g[:m] + g[m:])


def in_support(x, p):
    return (x > p[2]) & (x < p[3])


def log_prob(x, p):
    a, b, low, high = p
    u = ((x - low) / (high - low)).clamp(1e-300, 1.0 - 1e-16)
    norm = math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
    return norm + (a - 1.0) * torch.log(u) + (b - 1.0) * torch.log1p(-u) - math.log(high - low)
