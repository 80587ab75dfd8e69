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

from .distributions import (
    LogNormal,
    Normal,
    TruncatedNormal,
    TupleProduct,
    Uniform,
    product_distribution,
)
from .models.linear_gaussian import LinearGaussianModel
from .ops.batched_filter import from_cloud
from .ops.smoothing import SmoothedCloud
from .samplers.base import IBISState, SMC2State

# prior component kind -> (distribution, number of parameters)
_KINDS = {"normal": (Normal, 2), "uniform": (Uniform, 2), "lognormal": (LogNormal, 2),
          "truncated_normal": (TruncatedNormal, 4)}


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def from_numpy_state(fields: Mapping[str, np.ndarray], device="cuda") -> SMC2State:
    """A JAX ``SMC2State``'s fields (theta, log_omega, particles, log_w,
    log_z, ess, acc_ratio, t, and active_n and exchange_pending where they
    are not None), as numpy arrays, → the port's state. The (M, N, dx)
    particles get the port's planar storage; a missing live count is the
    array's N."""
    particles = np.asarray(fields["particles"], dtype=np.float32)
    cloud = _f32(np.ascontiguousarray(particles.transpose(0, 2, 1)), device)
    active_n, pending = fields.get("active_n"), fields.get("exchange_pending")
    return SMC2State(
        theta=_f32(fields["theta"], device),
        log_omega=_f32(fields["log_omega"], device),
        particles=from_cloud(cloud),
        log_w=_f32(fields["log_w"], device),
        log_z=_f32(fields["log_z"], device),
        ess=_f32(fields["ess"], device),
        acc_ratio=_f32(fields["acc_ratio"], device),
        t=int(fields["t"]),
        active_n=particles.shape[1] if active_n is None else int(active_n),
        exchange_pending=False if pending is None else bool(pending),
    )


def from_numpy_ibis_state(fields: Mapping[str, np.ndarray], device="cuda") -> IBISState:
    """A JAX ``IBISState``'s fields (theta, log_omega, mean, cov, log_z,
    ess, acc_ratio, t), as numpy arrays, → the port's state."""
    return IBISState(t=int(fields["t"]), **{
        k: _f32(fields[k], device)
        for k in ("theta", "log_omega", "mean", "cov", "log_z", "ess", "acc_ratio")})


def from_numpy_cloud(cloud, device="cuda") -> SmoothedCloud:
    """A JAX ``SmoothedCloud`` (particles (T, N, dx), log_weights,
    filter_log_weights (T, N), log_z) — the NamedTuple itself or a mapping
    of its fields, as numpy arrays or anything numpy converts — → the
    port's."""
    fields = cloud._asdict() if hasattr(cloud, "_asdict") else cloud
    return SmoothedCloud(**{k: _f32(fields[k], device) for k in SmoothedCloud._fields})


def from_numpy_path(path, device="cuda") -> torch.Tensor:
    """A trajectory (T, dx) — a CSMC reference path, a smoothed draw — as an
    f32 tensor on ``device``."""
    return _f32(path, device)


def from_numpy_model(fields: Mapping[str, np.ndarray], device="cuda") -> LinearGaussianModel:
    """A JAX ``LinearGaussianModel``'s arrays (A, B, Q, R, x0, sigma0), as
    numpy arrays with or without a leading θ axis, → the port's model."""
    return LinearGaussianModel(**{k: _f32(fields[k], device)
                                  for k in ("A", "B", "Q", "R", "x0", "sigma0")})


def prior_from_spec(spec: Sequence[tuple], device="cuda") -> TupleProduct:
    """A product prior from ``(kind, *params)`` rows: ``("uniform", low,
    high)``, ``("normal", loc, scale)``, ``("lognormal", mu, sigma)`` or
    ``("truncated_normal", loc, scale, low, high)`` — the JAX package's
    ``product_distribution`` of the same components."""
    comps = []
    for kind, *params in spec:
        if kind not in _KINDS:
            raise ValueError(f"unknown prior component {kind!r}; one of {sorted(_KINDS)}")
        dist, arity = _KINDS[kind]
        if len(params) != arity:
            raise ValueError(f"{kind!r} takes {arity} parameters, got {len(params)}")
        comps.append(dist(*(_f32(p, device) for p in params)))
    return product_distribution(comps)
