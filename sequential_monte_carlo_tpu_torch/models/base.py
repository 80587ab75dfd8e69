"""Ancestral simulation (L1) — counterpart of
``sequential_monte_carlo_tpu/models/base.py::simulate``.

A model is anything with ``initial_distribution()``,
``transition_distribution(x)`` and ``observation_distribution(x)``; states
carry a trailing state axis. Where the JAX package scans with split keys, the
port loops over T drawing from one ``torch.Generator``.
"""
from __future__ import annotations

import torch


def simulate(generator, model, T: int):
    """Draw (x_{1:T}, y_{1:T}) from one model: ``x`` (T, dx), ``y`` (T,)."""
    x = model.initial_distribution().sample(generator)
    xs = [x]
    ys = [model.observation_distribution(x).sample(generator)]
    for _ in range(T - 1):
        x = model.transition_distribution(x).sample(generator)
        xs.append(x)
        ys.append(model.observation_distribution(x).sample(generator))
    return torch.stack(xs), torch.stack(ys)
