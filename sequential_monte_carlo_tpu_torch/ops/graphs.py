"""CUDA-graph capture and replay of the masked particle filter's inner step
— the port's counterpart of the JAX package's jitted masked ``lax.scan``
(``sequential_monte_carlo_tpu/ops/batched_filter.py:540-555``), in the
L2.5 batched-filter layer.

An eager inner step issues ~15 launches from Python: 0.3–0.4 ms of the
host's time for 25–150 µs of device work at 512 θ (PERF.md §5). Here the
step is captured once as a CUDA graph, and
:func:`~.batched_filter.batched_log_likelihood_masked` replays it once per
live time: the host issues one graph launch a step, the mask is still read
on the host. The replays equal the eager loop bit for bit: the same
kernels and glue on the same inputs, the same Philox offsets.

Captured routes (:func:`~.batched_filter.captures`, beside the loop it
chooses for): on a CUDA device, no mesh, no
``proposal``, no ``active_n``, a model with a fused kernel whose fields are
all tensors, resampling by offsets (``systematic``,
``residual_systematic``: K1) or on a stratified grid (K3), at any
``ess_threshold`` (below 1 with K2's carry and the per-row selects), and
the auxiliary filter on those schemes (the lookahead, K1 or K3 on the
augmented cloud, K6 or K2 raw, the correction and normalize). Every other
route runs the eager loop, chosen by the configuration: a mesh (its
collectives cannot be captured), a guided proposal, a model without a
kernel (the DSL's plain route), multinomial, residual and metropolis, and
the elastic ``active_n``.

- Buffers (:class:`StepBuffers`): the graph reads and writes only tensors
  of its own — two clouds and two log-weight planes (graph 0 steps buffer
  0 into 1, graph 1 steps 1 into 0: the kernels write the next cloud in
  place through their ``out=``, so no step copies it), log Z, the
  observations, the live times and a position counter, the kernel
  parameters, and the model: a ``dataclasses.replace`` of the caller's whose
  tensor fields are buffers. Before a filter's replays every one is
  loaded from the new θ bank (:meth:`StepBuffers.load`): a replay never
  reads a tensor built for an earlier bank.
- Observations: y is copied to the device once a filter; a step takes y_t
  by ``index_select`` at the live time under the position counter, which
  the graph advances.
- Randomness: each captured route owns a generator registered with its
  graphs (``CUDAGraph.register_generator_state``). The caller's generator
  state (seed, Philox offset) is moved into it before the replays and back
  after them, so the replays draw at the eager loop's offsets and a run
  with a new generator replays without a new capture.
- Launch counts: the capture records the increase of every counter in the
  kernels' registry (``kernels/_build.py``: K1, K3, K6, K2 per instance,
  and any wrapper registered later) and restores them; every replay adds
  that increase, so the counts are the eager loop's.
- Warm-up and capture: a route's first filter runs its first live step
  eagerly on a side stream through the buffers (Triton's specialization,
  the kernel library's load and first-launch attributes), then both graphs
  are captured with ``capture_error_mode="global"``: a host sync inside a
  step raises.
- Cache: captured routes share one memory pool and sit in an LRU of
  :data:`CACHE_SIZE`, keyed by the route, the model's class and fields'
  shapes, the cloud's (M, dx, N) and dtype and the observations' buffer
  size; :func:`clear_graphs` frees them.
- No fallback: a capture or a replay that fails raises; outside
  :func:`disable_graphs` nothing runs the eager loop on a captured route.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch

from ..kernels._build import add_launch_counts, launch_counts, set_launch_counts
from . import batched_filter as _bf

__all__ = ["clear_graphs", "disable_graphs"]

CACHE_SIZE = 8  # captured routes kept, each two graphs and its buffers
_Y_MIN = 256  # least capacity of the observation and live-time buffers

_enabled = True
_cache: collections.OrderedDict = collections.OrderedDict()
_pool = None  # the memory pool every captured graph shares


@contextlib.contextmanager
def disable_graphs():
    """Inside the block the masked filter runs its eager loop on the card
    too — the counterpart of ``jax.disable_jit()``. Nests; the setting
    before it is restored on exit."""
    global _enabled
    before, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = before


def clear_graphs() -> None:
    """Free every captured graph, its buffers and the shared memory pool."""
    global _pool
    _cache.clear()
    _pool = None
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def enabled() -> bool:
    """False inside :func:`disable_graphs`."""
    return _enabled


class StepBuffers:
    """Everything a captured step reads and writes between filters.

    Built like one filter's inputs: the θ bank ``models``, its kernel
    ``params`` (None without), the init's (M, dx, N) ``cloud`` and (M, N)
    ``log_w``, the observations ``y``; ``capacity`` ≥ len(y) observations
    and live times. On the CPU the same step runs eagerly (the tests')."""

    def __init__(self, models, params, cloud, log_w, y, capacity: int):
        self.model = dataclasses.replace(models, **{
            f.name: torch.empty_like(getattr(models, f.name)) for f in dataclasses.fields(models)})
        self.params = None if params is None else torch.empty_like(params)
        self.clouds = (torch.empty_like(cloud), torch.empty_like(cloud))
        self.log_w = (torch.empty_like(log_w), torch.empty_like(log_w))
        self.log_z = torch.empty(log_w.shape[:1], device=log_w.device, dtype=log_w.dtype)
        self.y = torch.zeros(capacity, device=cloud.device, dtype=y.dtype)
        self.times = torch.zeros(capacity, device=cloud.device, dtype=torch.int64)
        self.pos = torch.zeros(1, device=cloud.device, dtype=torch.int64)

    def load(self, models, params, init, y, live) -> None:
        """Copy one filter's inputs in: the bank's fields and kernel
        parameters, the init into buffer 0, y, the live times (a CPU int64
        tensor), and the position back to the first."""
        for f in dataclasses.fields(models):
            getattr(self.model, f.name).copy_(getattr(models, f.name))
        if params is not None:
            self.params.copy_(params)
        self.clouds[0].copy_(_bf.as_cloud(init.particles))
        self.log_w[0].copy_(init.log_weights)
        self.log_z.copy_(init.log_mean)
        self.y[:y.shape[0]].copy_(y)
        # pinned, so the copy does not wait for the device
        self.times[:live.shape[0]].copy_(live.pin_memory() if self.times.is_cuda else live,
                                         non_blocking=True)
        self.pos.zero_()

    def step(self, generator, config, k: int) -> None:
        """One inner step at the next live time from buffer k into buffer
        1 − k, adding its evidence to log Z: the body a graph captures."""
        t = self.times.index_select(0, self.pos)
        y_t = self.y.index_select(0, t).reshape(())
        self.pos.add_(1)
        out = _bf.batched_pf_step(generator, self.model, _bf.from_cloud(self.clouds[k]),
                                  self.log_w[k], y_t, config, self.params,
                                  out=(self.clouds[1 - k], self.log_w[1 - k]))
        self.log_z.add_(out.log_mean)

    def result(self, k: int):
        """(particles (M, N, dx), log_w, log Z) of buffer k, as copies: the
        next filter overwrites the buffers."""
        return _bf.from_cloud(self.clouds[k].clone()), self.log_w[k].clone(), self.log_z.clone()


class _Route:
    """A captured route: its buffers, its generator, the two graphs (None
    until captured) and each graph's launches."""

    def __init__(self, buffers: StepBuffers, config, device):
        self.buffers, self.config = buffers, config
        self.generator = torch.Generator(device=device)
        self.graphs = None
        self.launches = None

    def capture(self) -> None:
        global _pool
        if _pool is None:
            _pool = torch.cuda.graph_pool_handle()
        before = launch_counts()
        graphs, launches = [], []
        try:
            for k in (0, 1):
                g = torch.cuda.CUDAGraph()
                g.register_generator_state(self.generator)
                start = launch_counts()
                with torch.cuda.graph(g, pool=_pool, capture_error_mode="global"):
                    self.buffers.step(self.generator, self.config, k)
                launches.append([a - b for a, b in zip(launch_counts(), start)])
                graphs.append(g)
        finally:
            set_launch_counts(before)  # a capture launches nothing
        self.graphs, self.launches = graphs, launches

    def replay(self, generator, k: int, steps: int) -> int:
        """Replay ``steps`` steps from buffer k with the caller's generator
        state; returns the buffer that holds the last step's output."""
        self.generator.set_state(generator.get_state())
        for _ in range(steps):
            self.graphs[k].replay()
            add_launch_counts(self.launches[k])
            k = 1 - k
        generator.set_state(self.generator.get_state())
        return k


def _key(models, params, cloud, y, config, capacity: int) -> tuple:
    fields = tuple((f.name, tuple(getattr(models, f.name).shape), getattr(models, f.name).dtype)
                   for f in dataclasses.fields(models))
    return (config.algorithm, config.resampling, config.ess_threshold, type(models), fields,
            None if params is None else tuple(params.shape), tuple(cloud.shape), cloud.dtype,
            cloud.device, y.dtype, capacity)


def filter_live(generator, models, init, params, y, live, config):
    """The masked filter's steps at the live times ``live`` (a non-empty
    CPU int64 tensor), from the init ``init``, by replaying the route's
    captured graphs (capturing them first where the cache has none).
    Returns (particles (M, N, dx), log_w (M, N), log Z (M,))."""
    cloud = _bf.as_cloud(init.particles)
    capacity = max(_Y_MIN, 1 << (y.shape[0] - 1).bit_length())
    key = _key(models, params, cloud, y, config, capacity)
    route = _cache.pop(key, None)
    if route is None:
        route = _Route(StepBuffers(models, params, cloud, init.log_weights, y, capacity),
                       config, cloud.device)
    route.buffers.load(models, params, init, y, live)
    k, steps = 0, live.shape[0]
    if route.graphs is None:
        # the warm-up: the first live step, eagerly, on a side stream
        side, main = torch.cuda.Stream(device=cloud.device), torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            route.buffers.step(generator, config, 0)
        main.wait_stream(side)
        k, steps = 1, steps - 1
        route.capture()
    _cache[key] = route
    while len(_cache) > CACHE_SIZE:
        _cache.popitem(last=False)
    if steps:
        k = route.replay(generator, k, steps)
    return route.buffers.result(k)
