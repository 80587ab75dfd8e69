"""Carry state across from the JAX package, through numpy.

The JAX package and the port draw different random numbers (threefry vs
Philox and PyTorch's generators), so the way to hold them against each other
is to start both from the same state: the JAX package's arrays, handed over
as numpy arrays, become the port's tensors on a chosen device. Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .distributions import Normal, TupleProduct, Uniform, product_distribution
from .ops.batched_filter import from_cloud
from .samplers.base import SMC2State

_KINDS = {"normal": Normal, "uniform": Uniform}


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def from_numpy_state(fields: Mapping[str, np.ndarray], device="cpu") -> SMC2State:
    """A JAX ``SMC2State``'s fields (theta, log_omega, particles, log_w,
    log_z, ess, acc_ratio, t), as numpy arrays, → the port's state. The
    (M, N, dx) particles get the port's planar storage."""
    particles = np.asarray(fields["particles"], dtype=np.float32)
    cloud = _f32(np.ascontiguousarray(particles.transpose(0, 2, 1)), device)
    return SMC2State(
        theta=_f32(fields["theta"], device),
        log_omega=_f32(fields["log_omega"], device),
        particles=from_cloud(cloud),
        log_w=_f32(fields["log_w"], device),
        log_z=_f32(fields["log_z"], device),
        ess=_f32(fields["ess"], device),
        acc_ratio=_f32(fields["acc_ratio"], device),
        t=int(fields["t"]),
    )


def prior_from_spec(spec: Sequence[tuple[str, float, float]],
                    device="cpu") -> TupleProduct:
    """A product prior from ``(kind, a, b)`` rows: ``("uniform", low,
    high)`` or ``("normal", loc, scale)`` — the JAX package's
    ``product_distribution`` of the same components."""
    comps = []
    for kind, a, b in spec:
        if kind not in _KINDS:
            raise ValueError(f"unknown prior component {kind!r}; one of {sorted(_KINDS)}")
        comps.append(_KINDS[kind](_f32(a, device), _f32(b, device)))
    return product_distribution(comps)
