"""Product priors in plain PyTorch, from a configuration's ``prior`` rows.

A row is ``[kind, *params]``: ``["uniform", low, high]``, ``["normal", loc,
scale]``, ``["lognormal", mu, sigma]`` or ``["truncated_normal", loc, scale,
low, high]``. The benchmark draws its own inputs with these (the filter
cell's θ banks) and the reference sampler's prior is this one; nothing here
comes from the program.
"""
from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
ARITY = {"uniform": 2, "normal": 2, "lognormal": 2, "truncated_normal": 4}


def _ndtr(x: float) -> float:
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


class Prior:
    """Independent components, one a column of θ."""

    def __init__(self, rows):
        for kind, *params in rows:
            if ARITY.get(kind) != len(params):
                raise ValueError(f"prior row {[kind, *params]}: unknown kind or arity")
        self.rows = [(kind, [float(p) for p in params]) for kind, *params in rows]

    @property
    def dim(self) -> int:
        return len(self.rows)

    def sample(self, generator, m: int, device, dtype=torch.float32) -> torch.Tensor:
        """(m, dim) draws, every column from one call on the device."""
        cols = []
        for kind, p in self.rows:
            if kind == "uniform":
                u = torch.rand(m, generator=generator, device=device, dtype=torch.float64)
                cols.append(p[0] + (p[1] - p[0]) * u)
            elif kind == "normal":
                z = torch.randn(m, generator=generator, device=device, dtype=torch.float64)
                cols.append(p[0] + p[1] * z)
            elif kind == "lognormal":
                z = torch.randn(m, generator=generator, device=device, dtype=torch.float64)
                cols.append(torch.exp(p[0] + p[1] * z))
            else:  # inverse cdf between the bounds' probabilities
                loc, scale, low, high = p
                a, b = _ndtr((low - loc) / scale), _ndtr((high - loc) / scale)
                u = torch.rand(m, generator=generator, device=device, dtype=torch.float64)
                q = a + (b - a) * u
                cols.append((loc + scale * torch.special.ndtri(q)).clamp(low, high))
        return torch.stack(cols, dim=1).to(dtype)

    def in_support(self, theta: torch.Tensor) -> torch.Tensor:
        ok = torch.isfinite(theta).all(dim=1)
        for j, (kind, p) in enumerate(self.rows):
            x = theta[:, j]
            if kind == "uniform":
                ok = ok & (x >= p[0]) & (x <= p[1])
            elif kind == "lognormal":
                ok = ok & (x > 0)
            elif kind == "truncated_normal":
                ok = ok & (x >= p[2]) & (x <= p[3])
        return ok

    def log_prob(self, theta: torch.Tensor) -> torch.Tensor:
        """(m,) log density; −inf outside the support."""
        total = torch.zeros(theta.shape[0], dtype=theta.dtype, device=theta.device)
        for j, (kind, p) in enumerate(self.rows):
            x = theta[:, j]
            if kind == "uniform":
                lp = torch.full_like(x, -math.log(p[1] - p[0]))
            elif kind == "normal":
                z = (x - p[0]) / p[1]
                lp = -0.5 * z * z - math.log(p[1]) - _HALF_LOG_2PI
            elif kind == "lognormal":
                lx = torch.log(x.clamp_min(1e-30))
                z = (lx - p[0]) / p[1]
                lp = -0.5 * z * z - math.log(p[1]) - _HALF_LOG_2PI - lx
            else:
                loc, scale, low, high = p
                mass = _ndtr((high - loc) / scale) - _ndtr((low - loc) / scale)
                z = (x - loc) / scale
                lp = -0.5 * z * z - math.log(scale) - _HALF_LOG_2PI - math.log(mass)
            total = total + lp
        return torch.where(self.in_support(theta), total, -torch.inf)
