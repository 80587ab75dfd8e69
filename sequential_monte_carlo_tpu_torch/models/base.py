"""The state-space-model protocol and ancestral simulation (L1) —
counterpart of ``sequential_monte_carlo_tpu/models/base.py`` — and the lift
of one θ's model to a θ-cloud of identical rows, and a θ-cloud's rows.

A model is anything with ``initial_distribution()``,
``transition_distribution(x)`` and ``observation_distribution(x)``
(:class:`StateSpaceModel`); states carry a trailing state axis. Where the JAX
package scans with split keys, the port loops over T drawing from one
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class StateSpaceModel(Protocol):
    """Duck-typed SSM: any object with these members qualifies. A θ-cloud
    of models is one model whose tensors carry a leading θ axis; its
    distribution methods take states with the θ axis just before the state
    axis, (..., M, dx)."""

    @property
    def state_dim(self) -> int:
        ...

    def initial_distribution(self):
        """Distribution over the initial state, event shape (dx,)."""

    def transition_distribution(self, x):
        """Distribution over x_t given x_{t-1} = x (..., dx)."""

    def observation_distribution(self, x):
        """Distribution over scalar y_t given x_t = x (..., dx)."""


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
    """One θ's model (any family: its tensor fields are that θ's parameters)
    as a θ-cloud of ``m`` identical rows: every tensor field gets a leading
    axis of length m; other fields (a DSL model's name, state names and
    functions) are carried through. The per-θ filters run the batched filter
    on this bank at m = 1."""
    fields = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}
    return dataclasses.replace(model, **{
        name: v.expand((m,) + tuple(v.shape)).contiguous()
        for name, v in fields.items() if isinstance(v, torch.Tensor)})


def model_rows(model, lo: int, hi: int):
    """Rows [lo, hi) of a θ-cloud model (any family): every tensor field
    sliced along its leading θ axis, as a view; other fields carried
    through. A θ-sharded filter runs its rank's rows on this."""
    fields = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}
    return dataclasses.replace(model, **{
        name: v[lo:hi] for name, v in fields.items() if isinstance(v, torch.Tensor)})
