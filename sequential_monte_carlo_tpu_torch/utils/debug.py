"""Numerical-debugging helpers — counterpart of
``sequential_monte_carlo_tpu/utils/debug.py``: NaN/Inf creep in log-weights
and degenerate clouds.

- :func:`check_state`: finite fraction, min and max of every floating
  tensor of a state (one host read each).
- :func:`assert_finite_weights`: raises ``FloatingPointError`` where a
  weight row is fully degenerate (all −inf or NaN), after one host read. The
  JAX package's second mode, a ``checkify`` check under ``jit``, has no
  counterpart: the port runs eagerly and has no jit.
- :func:`debug_nans`: a scope in which every torch operation whose floating
  output holds a NaN raises, naming the operation (a host read per
  operation: for diagnosis only). The hand-written CUDA kernels K1, K3 and
  K6 are launched through ``ctypes`` and do not pass through torch's
  dispatch, so the scope does not see them; :func:`check_state` after a step
  covers their outputs.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.overrides import TorchFunctionMode


def _leaves(obj, name: str):
    """(path, tensor) for every tensor in a dataclass, (named) tuple, list or
    dict, depth first."""
    if isinstance(obj, torch.Tensor):
        yield name, obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{name}.{f.name}")
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for k, v in zip(obj._fields, obj):
            yield from _leaves(v, f"{name}.{k}")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{name}[{i}]")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{name}[{k!r}]")


def check_state(state, name: str = "state") -> dict:
    """Diagnostics of a sampler or filter state: for every floating tensor,
    its finite fraction, min and max."""
    diag = {}
    for key, t in _leaves(state, name):
        if t.is_floating_point() and t.numel():
            diag[key] = {"finite_frac": torch.isfinite(t).double().mean().item(),
                         "min": t.min().item(), "max": t.max().item()}
    return diag


def assert_finite_weights(log_w, what: str = "log-weights"):
    """Raise ``FloatingPointError`` if any weight row (the last axis) has no
    finite entry; returns ``log_w``."""
    n_bad = int(torch.sum(~torch.any(torch.isfinite(log_w), dim=-1)))
    if n_bad:
        raise FloatingPointError(f"{what}: {n_bad} fully degenerate weight row(s)")
    return log_w


class _NaNCheck(TorchFunctionMode):
    """Raise at the first torch operation whose floating output holds a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for _, t in _leaves(out, "out"):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """A scope in which a torch operation that produces a NaN raises
    ``FloatingPointError`` naming it (slow — for diagnosis only); the state
    before the scope is restored on exit. ``enable=False``: a scope that
    checks nothing."""
    if not enable:
        yield
        return
    with _NaNCheck():
        yield
