"""CUDA-graph capture and replay of the port's filter loops — its counterpart
of the JAX package's compiled loops, in the L2.5 batched-filter layer:

- the masked filter (:func:`filter_live`, for
  :func:`~.batched_filter.batched_log_likelihood_masked`), JAX's jitted
  masked ``lax.scan`` (``sequential_monte_carlo_tpu/ops/batched_filter.py:540-555``);
- SMC²'s online step (:func:`online_route`, for ``SMC2.step``, ``run`` and
  ``run_segmented``), JAX's ``_step_jit`` and the scan of ``_run_jit``
  (``sequential_monte_carlo_tpu/samplers/smc2.py:340-343, 410-445``);
- the filters that store every step (:func:`filter_stored`, for
  ``filter_sequence`` and the smoothers' forward bank), JAX's scans in
  ``ops/particle_filter.py:315-348`` and ``ops/smoothing.py:106-124``;
- a conditional-SMC sweep (:func:`csmc_sweep`, for ``csmc_sweep``,
  ``csmc_forward`` and iterated CSMC), JAX's forward, lineage and
  backward-sampling scans (``ops/csmc.py:97-99, 116``,
  ``ops/smoothing.py:273``);
- a particle-Gibbs sweep (:func:`pg_chain`, for ``particle_gibbs`` and the
  chain bank), the body of JAX's scan over sweeps
  (``samplers/particle_gibbs.py:175-178``) with the MH chain's scan inside.

An eager inner step issues ~15 launches from Python: 0.3–0.4 ms of the
host's time for 25–150 µs of device work at 512 θ (PERF.md §5). Here a step
body is captured as CUDA graphs once a route, and the loops replay them. A
replayed run equals its eager twin (inside :func:`disable_graphs`) bit for
bit: the same kernels and glue on the same inputs, the same Philox offsets,
the same launch counts.

Captured routes (:func:`~.batched_filter.captures`): on a CUDA device, no
mesh, no ``proposal``, no ``active_n``, a model with a fused kernel whose
fields are all tensors, resampling by offsets (``systematic``,
``residual_systematic``: K1), on a stratified grid (K3) or multinomial
(its plain ancestors and gather), at any ``ess_threshold`` (below 1 with
K2's carry and the per-row selects), and the auxiliary filter on those
schemes (the lookahead, K1 or K3 on the augmented cloud, K6 or K2 raw, the
correction and normalize). A CSMC sweep is captured where its bank's
filter would be at the multinomial scheme; a PG sweep too, unless the
model's kernel parameters read the host (``params_read_host``: an LG model
at dx > 1, whose ``torch.linalg.eigh`` checks its errors on the host; a
capture refuses it), where the sweeps loop eagerly, each CSMC sweep on its
route (its parameters packed outside the graph). Every other route runs the
eager loop, chosen by the configuration: a mesh (its collectives cannot be
captured), a guided proposal, a model without a kernel (the DSL's plain
route), residual and metropolis, and the elastic ``active_n`` (so SMC²'s
"full" padding).

- Buffers: a graph reads and writes only tensors of its own — two clouds
  and two log-weight planes (a step from buffer k writes buffer 1 − k: the
  kernels write the next cloud in place through their ``out=``, so no step
  copies it), the running sums, the observations, the live times and a
  position counter, the kernel parameters, the model (a
  ``dataclasses.replace`` of the caller's whose tensor fields are buffers)
  and the per-step stores. A route's buffers are loaded before its replays
  (a filter's inputs; SMC²'s state, again after each rejuvenation): a
  replay never reads a tensor built for an earlier call.
- Graphs: one step from buffer 0 and one from buffer 1; for the loops with
  no host decision between their steps (the masked filter, the stored
  filters), also :data:`STEPS_PER_GRAPH` consecutive steps from buffer 0
  (an even count: it ends in buffer 0). L steps are ⌊L/S⌋ launches of it,
  then L mod S one-step launches.
- Online SMC²: the body is the online step after the decision (the inner
  step into the other buffer, log ω and log Z, the θ-ESS, the flag
  ESS < ess_min, the StepInfo fields into stores at the position counter).
  Before each replay the host reads the flag of the step before through a
  pinned buffer — the run's one host read a step — and, where it is set,
  runs the rejuvenation (the θ-resample, ``chain`` masked filters on their
  own replays, the exchange test) eagerly between replays and loads its
  result into the buffers.
- Stored filters: the body also writes each step's outputs (``emit``'s
  tree: ``filter_sequence``'s log-mean, ESS and ``summarize``'s outputs; the
  forward bank's cloud and log-weights) into (T, …) stores at the live time
  (``index_copy_``). ``summarize`` is captured inside the step, as JAX
  traces it into its scan: one that reads the host raises
  :class:`CaptureError`, naming it.
- Sweeps: a CSMC or PG route (``period`` 1) captures one whole sweep, its
  T − 1 steps unrolled (nothing in a sweep waits on the host), as one
  graph. A CSMC sweep reads the bank, its kernel parameters, y and the
  reference paths from buffers; its outputs are the tensors it wrote at
  capture, rewritten by each replay and copied out. A PG sweep reads θ,
  log λ, the paths, rw_sigma, y and the prior's tensors (its tree over
  buffers) from buffers and writes them back, its θ, acceptance and path
  stored at a sweep counter that the graph advances, the adaptation's rate
  (s + 1)^−0.6 taken at the counter from a table (the counterpart of the
  ``jnp.arange(sweeps)`` JAX feeds its scan); ``model_fn`` runs inside the
  graph: one that reads or copies from the host raises
  :class:`CaptureError` naming it. The set-up (θ0, the default rw_sigma's
  prior draws, the initial paths) runs before the replays.
- Observations: y is copied to the device once a call; a step takes y_t by
  ``index_select`` at the position counter, which the graph advances (a
  sweep's unrolled steps read their y_t as views).
- Randomness: each route owns a generator registered with its graphs
  (``CUDAGraph.register_generator_state``). The caller's generator state
  (seed, Philox offset) is moved into it before the replays and back after
  them, so the replays draw at the eager loop's offsets and a run with a
  new generator replays without a new capture.
- Launch counts: the capture records the increase of every counter in the
  kernels' registry (``kernels/_build.py``) a graph and restores them; each
  replay adds its graph's increase, so the counts are the eager loop's.
- Warm-up and capture: a route's first call runs one step eagerly on a side
  stream through the buffers (Triton's specialization, the kernel library's
  load and first-launch attributes), then undoes it (the generator's state,
  the counters and the buffers restored), and captures with
  ``capture_error_mode="global"``: a host sync inside a step raises.
- Cache: captured routes share one memory pool and sit in an LRU of
  :data:`CACHE_SIZE`, keyed by the kind of route, the configuration, the
  model's class and fields' shapes, the cloud's (M, dx, N) and dtype and
  the observations' buffer size (a CSMC sweep's: the kind, the method,
  the bank's class and fields' shapes, (M, N, T, dx) and dtype; a PG
  sweep's also ``model_fn`` by identity, the prior's structure and the
  PG configuration); :func:`clear_graphs` frees them.
- No fallback: a capture or a replay that fails raises; outside
  :func:`disable_graphs` nothing runs the eager loop on a captured route.

On the CPU nothing is captured: a route's "replays" run its step body
eagerly through the same buffers (the tests' way to hold the bodies against
the eager loops).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

from ..kernels._build import add_launch_counts, launch_counts, set_launch_counts
from . import batched_filter as _bf
from .weights import ess_from_log_weights

__all__ = ["CaptureError", "clear_graphs", "disable_graphs"]

CACHE_SIZE = 16  # captured routes kept: every route of a chip_smoke.py phase 30 cell
STEPS_PER_GRAPH = 8  # S: consecutive steps in one graph of the loops without a host decision
_Y_MIN = 256  # least capacity of the observation, live-time and store buffers

_enabled = True
_cache: collections.OrderedDict = collections.OrderedDict()
_pool = None  # the memory pool every captured graph shares


class CaptureError(RuntimeError):
    """A step body that cannot be captured (a host read inside it)."""


@contextlib.contextmanager
def disable_graphs():
    """Inside the block every loop runs eagerly on the card too — the
    counterpart of ``jax.disable_jit()``. Nests; the setting before it is
    restored on exit."""
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


def _capacity(t: int) -> int:
    return max(_Y_MIN, 1 << (t - 1).bit_length())


def _tree_key(obj):
    """A tree's structure (a model's or a prior's: dataclasses and tuples
    over tensors): its classes, its tensors' shapes, dtypes and devices,
    and its other leaves, by value where hashable, else by identity."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj),) + tuple(_tree_key(getattr(obj, f.name))
                                    for f in dataclasses.fields(obj))
    if isinstance(obj, tuple):
        return tuple(_tree_key(v) for v in obj)
    try:
        hash(obj)
    except TypeError:
        return _Same(obj)
    return obj


def _tree_buffers(obj):
    """``obj`` with every tensor of its tree replaced by a buffer like it."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_like(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _tree_buffers(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return type(obj)(_tree_buffers(v) for v in obj)
    return obj


def _tree_load(buffers, obj) -> None:
    """Copy the tensors of ``obj``'s tree into ``buffers`` (its
    :func:`_tree_buffers`)."""
    if isinstance(obj, torch.Tensor):
        buffers.copy_(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tree_load(getattr(buffers, f.name), getattr(obj, f.name))
    elif isinstance(obj, tuple):
        for b, v in zip(buffers, obj):
            _tree_load(b, v)


def _load_model(buffers, models, params) -> None:
    _tree_load(buffers.model, models)
    if params is not None:
        buffers.params.copy_(params)


def _leaves(tree) -> list:
    """The tensors of a tree of dicts and (named) tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure over the tensors ``leaves`` (an iterator)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        fields = [_rebuild(v, leaves) for v in tree]
        return type(tree)(*fields) if hasattr(tree, "_fields") else tuple(fields)
    return next(leaves)


class StepBuffers:
    """Everything a captured filter step reads and writes between calls.

    Built like one filter's inputs: the θ bank ``models``, its kernel
    ``params`` (None without), the init's (M, dx, N) ``cloud`` and (M, N)
    ``log_w``, the observations ``y``; ``capacity`` ≥ len(y) observations
    and live times. ``record(t, out)``, where given, writes a step's outputs
    (``out``, a ``BatchedPFOut`` of buffer views) at its live time t (a (1,)
    int64 tensor) into stores of its own."""

    def __init__(self, models, params, cloud, log_w, y, capacity: int, record=None):
        self.model = _tree_buffers(models)
        self.params = None if params is None else torch.empty_like(params)
        self.clouds = (torch.empty_like(cloud), torch.empty_like(cloud))
        self.log_w = (torch.empty_like(log_w), torch.empty_like(log_w))
        self.log_z = torch.empty(log_w.shape[:1], device=log_w.device, dtype=log_w.dtype)
        self.y = torch.zeros(capacity, device=cloud.device, dtype=y.dtype)
        self.times = torch.zeros(capacity, device=cloud.device, dtype=torch.int64)
        self.pos = torch.zeros(1, device=cloud.device, dtype=torch.int64)
        self.record = record

    def load(self, models, params, init, y, live) -> None:
        """Copy one filter's inputs in: the bank's fields and kernel
        parameters, the init into buffer 0, y, the live times (a CPU int64
        tensor), and the position back to the first."""
        _load_model(self, models, params)
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
        if self.record is not None:
            self.record(t, out)

    def result(self, k: int):
        """(particles (M, N, dx), log_w, log Z) of buffer k, as copies: the
        next call overwrites the buffers."""
        return _bf.from_cloud(self.clouds[k].clone()), self.log_w[k].clone(), self.log_z.clone()


class OnlineBuffers:
    """Everything SMC²'s captured online step reads and writes: the θ bank's
    model and kernel parameters, two clouds and two log-weight planes, log ω,
    log Z, the θ-ESS and its flag ESS < ``ess_min``, the acceptance rate, y,
    the position counter (the state's t) and the StepInfo stores (ESS,
    acceptance rate, evidence increment, by t). Built like the state
    ``state`` it first holds, with ``capacity`` ≥ len(y)."""

    def __init__(self, models, params, state, y, capacity: int, ess_min: float):
        device = state.theta.device
        cloud = _bf.as_cloud(state.particles)
        self.model = _tree_buffers(models)
        self.params = None if params is None else torch.empty_like(params)
        self.clouds = (torch.empty_like(cloud), torch.empty_like(cloud))
        self.log_w = (torch.empty_like(state.log_w), torch.empty_like(state.log_w))
        self.log_omega = torch.empty_like(state.log_omega)
        self.log_z = torch.empty_like(state.log_z)
        self.ess = torch.empty_like(state.ess)
        self.acc_ratio = torch.empty_like(state.acc_ratio)
        self.flag = torch.zeros((), dtype=torch.bool, device=device)
        self.y = torch.zeros(capacity, device=device, dtype=y.dtype)
        self.pos = torch.zeros(1, device=device, dtype=torch.int64)
        self.stores = {name: torch.zeros(capacity, device=device, dtype=like.dtype)
                       for name, like in (("ess", state.ess), ("acc_ratio", state.acc_ratio),
                                          ("log_evidence_incr", state.ess))}
        self.ess_min = ess_min
        cuda = device.type == "cuda"
        self.flag_host = torch.zeros(1, dtype=torch.bool, pin_memory=cuda)
        self.read_done = torch.cuda.Event() if cuda else None
        self.reads = 0

    def load(self, models, params, state, y=None) -> None:
        """Copy the state in (its clouds into buffer 0, its bank's fields and
        kernel parameters, t into the position counter, its ESS flag), and
        y where given."""
        _load_model(self, models, params)
        self.clouds[0].copy_(_bf.as_cloud(state.particles))
        self.log_w[0].copy_(state.log_w)
        self.log_omega.copy_(state.log_omega)
        self.log_z.copy_(state.log_z)
        self.ess.copy_(state.ess)
        self.acc_ratio.copy_(state.acc_ratio)
        torch.lt(self.ess, self.ess_min, out=self.flag)
        self.pos.fill_(state.t)
        if y is not None:
            self.y[:y.shape[0]].copy_(y)

    def step(self, generator, config, k: int) -> None:
        """The online step after the rejuvenation decision, from buffer k
        into buffer 1 − k ≡ ``SMC2.step``'s: the body a graph captures."""
        t = self.pos
        out = _bf.batched_pf_step(generator, self.model, _bf.from_cloud(self.clouds[k]),
                                  self.log_w[k], self.y.index_select(0, t).reshape(()), config,
                                  self.params, out=(self.clouds[1 - k], self.log_w[1 - k]))
        prev_lse = torch.logsumexp(self.log_omega, dim=0)
        self.log_omega.add_(out.log_mean)
        ess = ess_from_log_weights(self.log_omega)
        self.ess.copy_(ess)
        self.log_z.add_(out.log_mean)
        torch.lt(ess, self.ess_min, out=self.flag)
        incr = torch.logsumexp(self.log_omega, dim=0) - prev_lse
        for name, value in (("ess", ess), ("acc_ratio", self.acc_ratio),
                            ("log_evidence_incr", incr)):
            self.stores[name].index_copy_(0, t, value.reshape(1))
        self.pos.add_(1)

    def read_flag(self) -> bool:
        """The flag of the last step (or load): the host's one read a step,
        through the pinned buffer."""
        if self.read_done is None:
            self.flag_host.copy_(self.flag.reshape(1))
        else:
            self.flag_host.copy_(self.flag.reshape(1), non_blocking=True)
            self.read_done.record()
            self.read_done.synchronize()
        self.reads += 1
        return bool(self.flag_host[0])

    def fields(self, k: int) -> dict:
        """The state's tensors that the step writes, as views of buffer k."""
        return {"particles": _bf.from_cloud(self.clouds[k]), "log_w": self.log_w[k],
                "log_omega": self.log_omega, "log_z": self.log_z, "ess": self.ess}

    def infos(self, first: int, last: int) -> dict:
        """The StepInfo stores of the steps at t ∈ [first, last), as copies."""
        return {name: store[first:last].clone() for name, store in self.stores.items()}


class _Route:
    """A captured route: its buffers, its body ``body(generator, k)``, its
    generator, its graphs by (first buffer, steps) (None until captured)
    and each graph's launches; ``k``, the buffer that holds the last step's
    output; ``replays``, its graph launches (on the CPU, its bodies' runs
    grouped as the graphs would launch them). A filter's route (``period``
    2) captures one step from either buffer and, with ``multi``, also
    :data:`STEPS_PER_GRAPH` steps from buffer 0; a sweep's (``period`` 1)
    one body, whose outputs (``out``: what the body returned at capture, or
    on the CPU at its last run) each replay rewrites in place. ``timing``:
    the seconds of the warm-up, of the capture (the body's issue into the
    graphs) and of the instantiation."""

    def __init__(self, buffers, body, device, multi: bool, period: int = 2):
        self.buffers, self.body, self.device = buffers, body, device
        self.multi, self.period = multi, period
        self.generator = torch.Generator(device=device)
        self.graphs = None
        self.launches = {}
        self.k = 0
        self.replays = 0
        self.out = None
        self.timing = {}

    def load(self, *args) -> None:
        """Load the buffers (``buffers.load(*args)``); the next replay starts
        from buffer 0."""
        self.buffers.load(*args)
        self.k = 0

    def capture(self, generator, reload) -> None:
        """The warm-up (the body once eagerly on a side stream, then undone:
        the caller's generator state and the counters restored, ``reload()``
        loading the buffers again), then the graphs. On the CPU, nothing."""
        if self.device.type != "cuda":
            self.graphs = {}
            return
        global _pool
        if _pool is None:
            _pool = torch.cuda.graph_pool_handle()
        before, drawn = launch_counts(), generator.get_state()
        t0 = time.perf_counter()
        side, main = torch.cuda.Stream(device=self.device), torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.body(generator, 0)
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        timing = {"warmup_s": time.perf_counter() - t0, "capture_s": 0.0, "instantiate_s": 0.0}
        generator.set_state(drawn)
        set_launch_counts(before)
        reload()
        shapes = [(0, 1), (1, 1)] if self.period == 2 else [(0, 1)]
        if self.multi and STEPS_PER_GRAPH > 1:
            shapes.append((0, STEPS_PER_GRAPH))
        graphs, launches = {}, {}
        try:
            for k, steps in shapes:
                g = torch.cuda.CUDAGraph()
                g.register_generator_state(self.generator)
                start = launch_counts()
                t0 = time.perf_counter()
                try:
                    with torch.cuda.graph(g, pool=_pool, capture_error_mode="global"):
                        for i in range(steps):
                            out = self.body(self.generator, (k + i) % 2)
                        t1 = time.perf_counter()
                except RuntimeError as err:  # the body's own error, where it gave one
                    cause = err
                    while cause is not None and not isinstance(cause, CaptureError):
                        cause = cause.__context__
                    if cause is None or cause is err:
                        raise
                    raise CaptureError(str(cause)) from err
                timing["capture_s"] += t1 - t0
                timing["instantiate_s"] += time.perf_counter() - t1  # capture_end instantiates
                launches[(k, steps)] = [a - b for a, b in zip(launch_counts(), start)]
                graphs[(k, steps)] = g
                if (k, steps) == (0, 1):
                    self.out = out
        finally:
            set_launch_counts(before)  # a capture launches nothing
        self.graphs, self.launches, self.timing = graphs, launches, timing

    def _launch(self, generator, steps: int, times: int) -> None:
        """``times`` launches of the graph of ``steps`` steps from buffer
        ``self.k`` (on the CPU, its bodies with ``generator``)."""
        k = self.k
        if self.device.type == "cuda":
            g = self.graphs[(k, steps)]
            for _ in range(times):
                g.replay()
            add_launch_counts(self.launches[(k, steps)], times)
        else:
            for _ in range(times):
                for i in range(steps):
                    self.out = self.body(generator, (k + i) % 2)
        self.k = (k + steps * times) % self.period
        self.replays += times

    def replay(self, generator, steps: int) -> None:
        """``steps`` steps (a sweep route's: sweeps) from buffer ``self.k``
        with the caller's generator state: ⌊steps/S⌋ launches of the S-step
        graph (from buffer 0, on the routes that have one), then one launch
        a step."""
        cuda = self.device.type == "cuda"
        if cuda:
            self.generator.set_state(generator.get_state())
        if self.multi and STEPS_PER_GRAPH > 1 and self.k == 0 and steps >= STEPS_PER_GRAPH:
            self._launch(generator, STEPS_PER_GRAPH, steps // STEPS_PER_GRAPH)
            steps %= STEPS_PER_GRAPH
        for _ in range(steps):
            self._launch(generator, 1, 1)
        if cuda:
            generator.set_state(self.generator.get_state())


def _key(models, params, cloud, y, config, capacity: int) -> tuple:
    return (config.algorithm, config.resampling, config.ess_threshold, _tree_key(models),
            None if params is None else tuple(params.shape), tuple(cloud.shape), cloud.dtype,
            cloud.device, y.dtype, capacity)


def _ready(key, make, load, generator) -> _Route:
    """The cached route of ``key`` (``make()`` where the cache has none),
    loaded by ``load(route)`` and captured where it was not yet; kept in the
    cache only once captured."""
    route = _cache.pop(key, None)
    if route is None:
        route = make()
    load(route)
    if route.graphs is None:
        route.capture(generator, lambda: load(route))
    _cache[key] = route
    while len(_cache) > CACHE_SIZE:
        _cache.popitem(last=False)
    return route


def _filter_route(kind, generator, models, init, params, y, live, config, record_for=None):
    cloud = _bf.as_cloud(init.particles)
    capacity = _capacity(y.shape[0])
    key = kind + _key(models, params, cloud, y, config, capacity)

    def make():
        buffers = StepBuffers(models, params, cloud, init.log_weights, y, capacity)
        if record_for is not None:
            buffers.record = record_for(buffers)
        return _Route(buffers, lambda gen, k: buffers.step(gen, config, k), cloud.device, True)

    return _ready(key, make, lambda route: route.load(models, params, init, y, live), generator)


def filter_live(generator, models, init, params, y, live, config):
    """The masked filter's steps at the live times ``live`` (a non-empty
    CPU int64 tensor), from the init ``init``, by replaying the route's
    captured graphs (capturing them first where the cache has none).
    Returns (particles (M, N, dx), log_w (M, N), log Z (M,))."""
    route = _filter_route(("masked",), generator, models, init, params, y, live, config)
    route.replay(generator, live.shape[0])
    return route.buffers.result(route.k)


def filter_stored(generator, models, init, params, y, config, emit, tag):
    """The filter over all of y (T ≥ 2) from the init ``init``, replayed,
    with ``emit(out)``'s tree of tensors (``out`` a ``BatchedPFOut``) stored
    at every step: (particles (M, N, dx), log_w, log Z, the tree stacked
    over the T steps, the init's first). ``tag`` (hashable) names what emit
    computes in the cache's key. An ``emit`` that reads the host raises
    :class:`CaptureError` at capture."""
    first = emit(init)
    leaves = _leaves(first)
    device = init.log_weights.device
    for leaf in leaves:
        if not (isinstance(leaf, torch.Tensor) and leaf.device == device):
            what = (f"a tensor on {leaf.device}" if isinstance(leaf, torch.Tensor)
                    else f"a {type(leaf).__name__}")
            raise CaptureError(f"{tag[-1]!r} returned {what}, not a tensor on {device}: a"
                               " replayed step cannot store it")
    capacity = _capacity(y.shape[0])

    def record_for(buffers):
        buffers.stores = [torch.empty((capacity,) + tuple(x.shape), dtype=x.dtype, device=device)
                          for x in leaves]

        def record(t, out):
            try:
                values = _leaves(emit(out))
            except RuntimeError as err:
                if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                    raise CaptureError(
                        f"{tag[-1]!r} cannot be captured into the replayed step: it reads the"
                        " host (.item(), .cpu(), a tensor made from Python numbers on the"
                        " device, ...). Make it capturable, or run inside"
                        f" disable_graphs(). ({err})") from err
                raise
            for store, value in zip(buffers.stores, values, strict=True):
                store.index_copy_(0, t, value.unsqueeze(0))
        return record

    live = torch.arange(1, y.shape[0])
    route = _filter_route(("stored",) + tuple(tag), generator, models, init, params, y, live,
                          config, record_for)
    for store, leaf in zip(route.buffers.stores, leaves):
        store[0].copy_(leaf)
    route.replay(generator, live.shape[0])
    t = y.shape[0]
    series = _rebuild(first, iter([store[:t].clone() for store in route.buffers.stores]))
    return route.buffers.result(route.k) + (series,)


def online_route(generator, sampler, state, y) -> _Route:
    """SMC²'s online route for the sampler's configuration at the state's
    shapes, with the state and y loaded (captured first where the cache has
    none)."""
    cfg = sampler.config
    models = sampler.model_fn(state.theta)
    params = _bf.kernel_params(models, cfg.inner)
    cloud = _bf.as_cloud(state.particles)
    capacity = _capacity(y.shape[0])
    key = ("online", cfg.ess_min) + _key(models, params, cloud, y, cfg.inner, capacity)

    def make():
        buffers = OnlineBuffers(models, params, state, y, capacity, cfg.ess_min)
        return _Route(buffers, lambda gen, k: buffers.step(gen, cfg.inner, k), cloud.device,
                      False)

    return _ready(key, make, lambda route: route.load(models, params, state, y), generator)


class _Same:
    """A key's part that equals only another of the same object (a
    function), which it holds alive: a graph reads the tensors that object
    built or holds at capture. A wrapper made by ``functools.wraps`` stands
    for the function it wraps (``__wrapped__``)."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = getattr(obj, "__wrapped__", obj)

    def __eq__(self, other) -> bool:
        return isinstance(other, _Same) and other.obj is self.obj

    def __hash__(self) -> int:
        return id(self.obj)


def _name(obj) -> str:
    obj = getattr(obj, "__wrapped__", obj)
    return getattr(obj, "__qualname__", None) or type(obj).__name__


def _guard(fn, what: str, device):
    """``fn``, raising :class:`CaptureError` naming ``what`` where it fails
    inside a capture (a host read or a copy from host memory)."""
    def call(*args):
        try:
            return fn(*args)
        except RuntimeError as err:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise CaptureError(
                    f"{what} cannot be captured into the replayed sweep: it reads the host"
                    " (.item(), .cpu(), a tensor made from Python numbers on the device, ...)."
                    f" Make it capturable, or run inside disable_graphs(). ({err})") from err
            raise
    return call


def _clone(tree):
    """Copies of a tree's tensors (None kept), in its structure."""
    return _rebuild(tree, iter([None if x is None else x.clone() for x in _leaves(tree)]))


class SweepBuffers:
    """Everything a captured CSMC sweep reads: the M-row bank's fields and
    kernel parameters (``params``, None without), the observations y (T,)
    and the reference paths ``ref`` (T, M, dx). Its outputs are the tensors
    the body wrote at capture (:attr:`_Route.out`)."""

    def __init__(self, bank, params, y, ref):
        self.model = _tree_buffers(bank)
        self.params = None if params is None else torch.empty_like(params)
        self.y, self.ref = torch.empty_like(y), torch.empty_like(ref)

    def load(self, bank, params, y, ref) -> None:
        _load_model(self, bank, params)
        self.y.copy_(y)
        self.ref.copy_(ref)


def csmc_sweep(generator, bank, n: int, y, ref, ancestor_sampling: bool, draw, sweep):
    """One conditional-SMC sweep of an M-row bank, replayed whole from one
    graph: ``sweep(generator, bank, n, y, ref, ancestor_sampling, draw,
    params)`` is the eager sweep (``ops/csmc.py::_csmc_eager``: the init
    with slot 0 pinned, the T − 1 conditional steps, and with ``draw`` the
    path draw), captured over the route's buffers. Returns copies of its
    outputs."""
    params = _bf.kernel_params(bank)
    key = ("csmc", ancestor_sampling, draw, n, _tree_key(bank), tuple(ref.shape), ref.dtype,
           ref.device, tuple(y.shape), y.dtype)

    def make():
        buffers = SweepBuffers(bank, params, y, ref)
        return _Route(buffers, lambda gen, k: sweep(gen, buffers.model, n, buffers.y, buffers.ref,
                                                    ancestor_sampling, draw, buffers.params),
                      ref.device, False, period=1)

    route = _ready(key, make, lambda route: route.load(bank, params, y, ref), generator)
    route.replay(generator, 1)
    return _clone(route.out)


class ChainBuffers:
    """Everything a captured particle-Gibbs sweep reads and writes: the K
    chains' θ (K, d), log λ (K,), paths (T, K, dx), the base proposal stds
    ``rw_sigma`` (d,), y (T,), the prior (its tree over buffers,
    :func:`_tree_buffers`), the sweep counter, the adaptation's rates
    (s + 1)^−0.6 at each sweep s (f32, as the eager loop's Python float
    meets the f32 acceptance), and the (capacity, …) stores of θ, the
    acceptance and, with ``collect``, the path at each sweep."""

    def __init__(self, theta, path, rw_sigma, y, prior, capacity: int, collect: bool):
        device = theta.device
        self.prior = _tree_buffers(prior)
        self.theta, self.log_lam = torch.empty_like(theta), torch.empty_like(theta[:, 0])
        self.path, self.rw_sigma = torch.empty_like(path), torch.empty_like(rw_sigma)
        self.y = torch.empty_like(y)
        self.counter = torch.zeros(1, device=device, dtype=torch.int64)
        rates = torch.tensor([(s + 1.0) ** -0.6 for s in range(capacity)], dtype=torch.float32)
        # pinned, so the copy does not wait for the device
        self.rates = rates.pin_memory().to(device, non_blocking=True) if theta.is_cuda else rates
        self.thetas = torch.empty((capacity,) + tuple(theta.shape), device=device,
                                  dtype=theta.dtype)
        self.accs = torch.empty((capacity, theta.shape[0]), device=device, dtype=theta.dtype)
        self.paths = (torch.empty((capacity,) + tuple(path.shape), device=device, dtype=path.dtype)
                      if collect else None)

    def load(self, theta, path, rw_sigma, y, prior) -> None:
        """The chains' start (θ0, log λ = 0, the initial paths), rw_sigma, y,
        the prior's tensors and the counter back to the first sweep."""
        _tree_load(self.prior, prior)
        self.theta.copy_(theta)
        self.log_lam.zero_()
        self.path.copy_(path)
        self.rw_sigma.copy_(rw_sigma)
        self.y.copy_(y)
        self.counter.zero_()

    def sweep(self, generator, sweep) -> None:
        """One Gibbs sweep from the buffers into them, its θ, acceptance and
        path stored at the counter, which it advances: the body a graph
        captures."""
        rate = self.rates.index_select(0, self.counter)
        theta, log_lam, acc, path = sweep(generator, self.y, self.rw_sigma, self.theta,
                                          self.log_lam, self.path, rate)
        self.thetas.index_copy_(0, self.counter, theta.unsqueeze(0))
        self.accs.index_copy_(0, self.counter, acc.unsqueeze(0))
        if self.paths is not None:
            self.paths.index_copy_(0, self.counter, path.unsqueeze(0))
        self.theta.copy_(theta)
        self.log_lam.copy_(log_lam)
        self.path.copy_(path)
        self.counter.add_(1)


def pg_chain(generator, sweeps: int, static, bank_fn, prior, bank, theta, path, rw_sigma, y,
             collect: bool, sweep):
    """``sweeps`` particle-Gibbs sweeps of K chains, one graph launch a
    sweep. ``sweep(generator, y, rw_sigma, θ, log λ, path, rate, bank_fn=,
    prior=)`` → (θ, log λ, acceptance, path) is the eager sweep
    (``samplers/particle_gibbs.py::_sweep``: the MH steps, the adaptation at
    ``rate``, the bank at the new θ and its CSMC sweep), captured over the
    route's buffers (the prior's among them) with ``bank_fn`` and the
    prior's methods guarded (:func:`_guard`: one that reads the host raises
    :class:`CaptureError` naming it). ``static`` (hashable) names the rest
    of the sweep's configuration in the key, beside ``bank_fn`` (by
    identity) and the prior's structure; ``bank`` is the bank at θ0 (its
    fields' shapes key the route). Returns (θ (sweeps, K, d), acceptances
    (sweeps, K), the final paths, the paths (sweeps, T, K, dx) or None)."""
    capacity = _capacity(sweeps)
    device = theta.device
    key = ("pg", static, _Same(bank_fn), _tree_key(prior), _tree_key(bank), tuple(theta.shape),
           tuple(path.shape), tuple(y.shape), y.dtype, device, collect, capacity)

    def make():
        buffers = ChainBuffers(theta, path, rw_sigma, y, prior, capacity, collect)
        fn = _guard(bank_fn, f"model_fn {_name(bank_fn)!r}", device)
        pr = _GuardedPrior(buffers.prior, device)
        return _Route(buffers, lambda gen, k: buffers.sweep(
            gen, lambda *args: sweep(*args, bank_fn=fn, prior=pr)), device, False, period=1)

    route = _ready(key, make, lambda route: route.load(theta, path, rw_sigma, y, prior),
                   generator)
    route.replay(generator, sweeps)
    b = route.buffers
    return (b.thetas[:sweeps].clone(), b.accs[:sweeps].clone(), b.path.clone(),
            None if b.paths is None else b.paths[:sweeps].clone())


class _GuardedPrior:
    """A prior's ``log_prob`` and ``in_support`` guarded (:func:`_guard`),
    naming the prior."""

    def __init__(self, prior, device):
        what = f"the prior's {{}} ({type(prior).__name__})"
        self.log_prob = _guard(prior.log_prob, what.format("log_prob"), device)
        self.in_support = _guard(prior.in_support, what.format("in_support"), device)
