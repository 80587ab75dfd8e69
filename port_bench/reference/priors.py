"""Product priors in plain PyTorch, from a configuration's ``prior`` rows.

A row is ``[kind, *params]``, its kind a file ``prior_kinds/<kind>.py``
found by name (``uniform``, ``normal``, ``lognormal``,
``truncated_normal``, and any added as a file there). The benchmark draws
its own inputs with these (the filter cell's θ banks) and the reference
sampler's prior is this one; nothing here comes from the program.
"""
from __future__ import annotations

import torch

from port_bench.harness import catalog


class Prior:
    """Independent components, one a column of θ."""

    def __init__(self, rows):
        self.rows = []
        for name, *params in rows:
            module = catalog.load_module("reference/prior_kinds", name)
            if module.ARITY != len(params):
                raise ValueError(f"prior row {[name, *params]}: {name} takes {module.ARITY}")
            self.rows.append((module, [float(p) for p in params]))

    @property
    def dim(self) -> int:
        return len(self.rows)

    def sample(self, generator, m: int, device, dtype=torch.float32) -> torch.Tensor:
        """(m, dim) draws, every column from one call on the device, in row
        order."""
        cols = [module.sample(generator, m, device, p) for module, p in self.rows]
        return torch.stack(cols, dim=1).to(dtype)

    def in_support(self, theta: torch.Tensor) -> torch.Tensor:
        ok = torch.isfinite(theta).all(dim=1)
        for j, (module, p) in enumerate(self.rows):
            ok = ok & module.in_support(theta[:, j], p)
        return ok

    def log_prob(self, theta: torch.Tensor) -> torch.Tensor:
        """(m,) log density; −inf outside the support."""
        total = torch.zeros(theta.shape[0], dtype=theta.dtype, device=theta.device)
        for j, (module, p) in enumerate(self.rows):
            total = total + module.log_prob(theta[:, j], p)
        return torch.where(self.in_support(theta), total, -torch.inf)
