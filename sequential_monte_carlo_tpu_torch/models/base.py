"""Ancestral simulation (L1) — counterpart of
``sequential_monte_carlo_tpu/models/base.py::simulate`` — and the lift of
one θ's model to a θ-cloud of identical rows.

A model is anything with ``initial_distribution()``,
``transition_distribution(x)`` and ``observation_distribution(x)``; states
carry a trailing state axis. Where the JAX package scans with split keys, the
port loops over T drawing from one ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

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


def broadcast_model(model, m: int = 1):
    """One θ's model (any family: its dataclass fields are that θ's tensors)
    as a θ-cloud of ``m`` identical rows: every field gets a leading axis of
    length m. The per-θ filters run the batched filter on this bank at
    m = 1."""
    return dataclasses.replace(model, **{
        f.name: getattr(model, f.name).expand((m,) + tuple(getattr(model, f.name).shape))
        .contiguous() for f in dataclasses.fields(model)})
