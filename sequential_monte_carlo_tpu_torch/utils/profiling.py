"""Tracing and timing helpers — counterpart of
``sequential_monte_carlo_tpu/utils/profiling.py``.

- :data:`named_scope`: ``torch.profiler.record_function``, a labelled range
  in a trace (the counterpart of ``jax.named_scope``). The filters' hot
  inner step carries none: it is bound by the host's issuing, which a scope
  would add to.
- :func:`trace`: a ``torch.profiler`` trace of a block — the host's
  operations and, where a card is present, its kernels (CUPTI's CUDA
  activity, which also records the kernels launched through ``ctypes``) —
  written as a Chrome trace to ``<logdir>/trace.json``.
- :func:`timeit`: the best wall-clock time of a callable, the card
  synchronized around each call.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

named_scope = torch.profiler.record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace: ``with trace("traces/run") as prof: run()``;
    the trace is written to ``<logdir>/trace.json`` on exit, and ``prof`` is
    the ``torch.profiler.profile`` object (``prof.key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, repeats: int = 3, warmup: int = 1, **kwargs):
    """Wall-clock ``fn(*args, **kwargs)``, the card synchronized before and
    after each call. Returns (best seconds over ``repeats``, last result)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    best = float("inf")
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best, result
