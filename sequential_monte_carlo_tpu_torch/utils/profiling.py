"""Tracing helpers — counterpart of ``sequential_monte_carlo_tpu/utils/profiling.py``.

- :func:`named_scope`: a labelled host range in a ``torch.profiler`` trace
  (the counterpart of ``jax.named_scope``), a shared no-op context while no
  profiler is active (~0.2 µs: one check of the profiler's flag). The port
  opens these spans at its phase boundaries, never inside a captured body,
  around a replay or in the inner step (which is bound by the host's
  issuing): ``smc.run`` (``SMC2.run_segmented``), ``smc.init``
  (``SMC2.init``), ``smc.online_step`` (a replayed or eager online step),
  ``smc.rejuvenate`` (``SMC2._resample_move``, shared with density-tempered
  SMC), ``smc.filter`` (``batched_log_likelihood_masked``, so also
  ``batched_log_likelihood``), ``smc.filter_init`` (its eager init),
  ``smc.route`` (``graphs._ready``: a route's key, cache lookup and load)
  and ``smc.capture`` (``graphs._Route.capture``). Each range is a host
  event on the trace's clock, the clock of the device's events; it is
  recorded at the profiler's function scope, not as a user annotation, so
  the profiler mirrors none of them onto the device's timeline, where it
  would read as device work.
- :func:`trace`: a ``torch.profiler`` trace of a block — the host's
  operations and, where a card is present, its kernels (CUPTI's CUDA
  activity, which also records the kernels launched through ``ctypes``) —
  written as a Chrome trace to ``<logdir>/trace.json``.
"""
from __future__ import annotations

import contextlib
import os

import torch

_NO_SPAN = contextlib.nullcontext()


def named_scope(name: str):
    """``with named_scope("smc.x"):`` — a profiler range named ``name``
    while a profiler is active, else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


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
