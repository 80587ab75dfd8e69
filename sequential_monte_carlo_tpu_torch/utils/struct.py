"""Plain dataclass helper — the counterpart of the JAX package's pytree
dataclass (``sequential_monte_carlo_tpu/utils/struct.py``).

PyTorch runs eagerly and needs no pytree registration: framework objects
(distributions, models, sampler states) are frozen dataclasses whose fields
are tensors, and :func:`replace` returns a copy with some fields changed.
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

T = TypeVar("T")


def struct(cls: type[T]) -> type[T]:
    """Decorator: a frozen dataclass."""
    return dataclasses.dataclass(frozen=True)(cls)


def replace(obj: T, **changes) -> T:
    """``dataclasses.replace`` under the JAX package's name."""
    return dataclasses.replace(obj, **changes)
