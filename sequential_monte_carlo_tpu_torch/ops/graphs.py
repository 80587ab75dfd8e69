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
  (``samplers/particle_gibbs.py:175-178``) with the MH chain's scan inside;
- the Kalman bank's loops (:func:`kalman_live`, :func:`kalman_masked`,
  :func:`kalman_stored`, for ``ops/kalman.py``'s functions and IBIS's
  rejuvenations), JAX's scans in ``ops/kalman.py:74-108``;
- IBIS's online step (:func:`ibis_route`, for ``IBIS.step`` and ``run``),
  JAX's ``_step_jit`` and the scan of ``_run_jit``
  (``samplers/ibis.py:113-148, 214-225``).

An eager inner step issues ~15 launches from Python: 0.3–0.4 ms of the
host's time for 25–150 µs of device work at 512 θ (PERF.md §5). Here a step
body is captured as CUDA graphs once a route, and the loops replay them. A
replayed run equals its eager twin (inside :func:`disable_graphs`) bit for
bit: the same kernels and glue on the same inputs, the same Philox offsets,
the same launch counts.

Captured routes (:func:`~.batched_filter.captures`): on a CUDA device, no
mesh; any model — a fused kernel's (K2, K6), or a DSL
model's plain propagate route (its draw from the transition and the
observation density, ~50 small launches a step, all captured) — whose
tensor fields become buffers and whose other leaves (name, state names,
functions by identity) key the route; the bootstrap, a guided ``proposal``
(its step's draw and the importance-corrected weight; keyed by the
proposal's functions) or the auxiliary filter (the lookahead, K1 or K3 on
the augmented cloud, the propagate, the correction and normalize); every
scheme: by offsets (``systematic``, ``residual_systematic``: K1), on a
stratified grid (K3), multinomial, residual and metropolis (their
ancestors on the device and a gather), at any ``ess_threshold`` (below 1
with K2's carry or the plain normalize, and the per-row selects). A CSMC
sweep is captured where its bank's filter would be at the multinomial
scheme; a PG sweep too, unless the model's kernel parameters read the host
(``params_read_host``: an LG model at dx > 1), where the sweeps loop
eagerly, each CSMC sweep on its route (its parameters packed outside the
graph). The elastic ``active_n`` (SMC²'s "full" padding) is captured too,
one route per live count: every tensor of an elastic step has the padded
shape, and the live count enters only as host scalars of its glue (the
live-prefix grid's divisor, the live mask, log active_n), which the graph
holds as they were at capture, so the count keys the route
(:func:`_key`). On a mesh (``config.mesh``) every loop replays too, keyed
by the mesh, this rank's rows and particles (:func:`_mesh_key`): a
θ-only mesh's inner step has no collective and replays as one process's
does, S steps a launch; a step with collectives (a particle mesh's gathers,
the online steps' gather of the evidence over the θ group) is captured as
segments with the collectives between them (cuts, below). One rule is read
from the warm-up (below): a step that
runs ``torch.linalg.eigh`` (``distributions/mvnormal.py::eigh``: an
``MvNormal`` with ``allow_singular``, the default, as an LG model's
transition at dx > 1, so a guided proposal or a smoother's backward draw
on it) is not captured, since CUDA's eigh checks its errors on the host,
which a capture refuses; that route runs its step bodies eagerly through
its buffers (``_Route.graphed`` False), with the same bits.

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
- Online SMC² and IBIS: the body is the online step after the decision
  (the inner step — the filter's, or the Kalman update — into the other
  buffer, on a mesh the θ group's gather of its per-θ evidence, log ω and
  log Z, the θ-ESS, the flag ESS < ess_min, the StepInfo
  fields into stores at the position counter). Before each replay the host
  reads the flag of the step before through a pinned buffer — the run's one
  host read a step — and, where it is set, runs the rejuvenation (the
  θ-resample, ``chain`` masked filters or Kalman passes on their own
  replays, the exchange test) eagerly between replays and loads its result
  into the buffers; under "full" padding, where the exchange doubled the
  live count, into the route of the new count (the doubled refilter's
  masked filter replays that count's route too). SMC²'s ``collect_fn``
  runs inside its step, as JAX
  traces it into its scan (:class:`_Collector`): on the state the step
  wrote, ``t`` the position counter and ``exchange_pending`` a flag buffer
  as device tensors, its outputs stored at t; one that reads the host
  raises :class:`CaptureError`, naming it. The route is keyed by it
  (:class:`_Same`).
- Kalman loops: a bank's (mean, cov) in two buffers, log Z, y and the
  position counter; the live loop runs a prefix of L steps (IBIS's t, a
  host int) as the masked filter does, ⌊L/S⌋ S-step launches and L mod S
  one-step launches; the masked loop runs all T steps, each a
  ``torch.where`` on the mask's buffer (JAX's ``jnp.where``), so the mask
  is never read on the host; the stored loop writes each step's mean, cov
  and log-likelihood into (T, …) stores.
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
  new generator replays without a new capture. The Kalman and IBIS routes
  draw nothing and take no generator.
- Launch counts: the capture records the increase of every counter in the
  kernels' registry (``kernels/_build.py``) a graph and restores them; each
  replay adds its graph's increase, so the counts are the eager loop's.
- Warm-up and capture: a route's first call runs one step eagerly (on the
  card on a side stream) through the buffers (Triton's specialization, the
  kernel library's load and first-launch attributes, the eigh rule), then
  undoes it (the generator's state, the counters and the buffers
  restored), and captures with ``capture_error_mode="global"``: a host sync
  inside a step raises. A model's function, a proposal's step, ``summarize``,
  ``model_fn`` or a prior that reads the host raises :class:`CaptureError`
  naming it (:func:`capture_error`).
- Cache: captured routes share one memory pool and sit in an LRU of
  :data:`CACHE_SIZE`, keyed by the kind of route, the configuration (its
  proposal's functions by identity), the model's tree (:func:`_tree_key`),
  the cloud's (M, dx, N) and dtype, the observations' buffer size and the
  live count (None without ``active_n``; every live count of a padded run
  has the same buffer shapes, so a key without it would replay another
  count's graph) (a CSMC sweep's: the kind, the method,
  the bank's class and fields' shapes, (M, N, T, dx) and dtype; a PG
  sweep's also ``model_fn`` by identity, the prior's structure and the
  PG configuration); :func:`clear_graphs` frees them.
- Cuts: a collective inside a captured body (``ops/sharding.py::_collective``)
  ends the graph there: the capture records it on the step's tensors
  without running it (the input holds no values yet; every rank records
  the same cuts in lockstep) and begins the next segment's graph in the
  same pool, keeping the collective's input and output alive for the
  segments. A replayed step is segment 0, collective 0, segment 1, …: the
  collectives run eagerly through ``_collective``, on gloo (which cannot
  run inside a graph) and NCCL alike, so ``collective_stats`` counts what
  the eager loop counts. A route whose step has a cut replays one step a
  launch; its launch counts and generator carry across the segments as
  across graphs. On a mesh route a collective that reaches
  ``torch.distributed`` other than through ``_collective`` raises
  :class:`CaptureError` naming it.
- No fallback: a capture or a replay that fails raises; outside
  :func:`disable_graphs` nothing runs the eager loop on a captured route.
- Counters: :data:`graph_stats` sums over every route of the process, at
  the points where a route updates its own counters (whose fields stay):
  ``captures`` (routes built: their warm-up, and on the card their
  capture), ``warmup_s``, ``capture_s``, ``instantiate_s`` (their
  ``timing``), ``replays`` (graph launches: a route's ``segment_replays``),
  ``replayed_steps`` (the steps those launches ran; a sweep route's sweeps)
  and ``evictions`` (routes dropped from the LRU). :func:`clear_graphs`
  leaves it as it is. A route's lookup and load run in the span
  ``smc.route``, its warm-up and capture in ``smc.capture``
  (``utils/profiling.py``); no span opens inside a captured body or around
  a replay.

On the CPU nothing is captured: a route's "replays" run its step body
eagerly through the same buffers (the tests' way to hold the bodies against
the eager loops), after the same warm-up.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import types

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..distributions.mvnormal import eigh
from ..kernels._build import add_launch_counts, launch_counts, set_launch_counts
from ..utils.profiling import named_scope
from ..utils.struct import replace
from . import batched_filter as _bf
from . import kalman as _kf
from . import sharding as _sh
from .particle_filter import Proposal
from .sharding import all_gather_rows, collective_stats
from .weights import ess_from_log_weights

__all__ = ["CaptureError", "clear_graphs", "disable_graphs"]

# captured routes kept: every route of a chip_smoke.py phase 30 cell; a
# "full"-padding SMC² run from N to 8N holds 4 live counts × (masked,
# online), and 4 online routes more with a collector
CACHE_SIZE = 16
STEPS_PER_GRAPH = 8  # S: consecutive steps in one graph of the loops without a host decision
_Y_MIN = 256  # least capacity of the observation, live-time and store buffers

_enabled = True
_cache: collections.OrderedDict = collections.OrderedDict()
_pool = None  # the memory pool every captured graph shares
# every route's builds, seconds, launches and evictions, summed (module docstring)
graph_stats = collections.Counter()


class CaptureError(RuntimeError):
    """A step body that cannot be captured (a host read inside it)."""


def capture_error(err: RuntimeError, what: str, device):
    """The :class:`CaptureError` naming ``what`` for ``err``, raised while
    ``device``'s current stream is capturing; None outside a capture."""
    if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
        return None
    if isinstance(err, CaptureError):  # a refusal from inside it (a direct collective)
        return CaptureError(f"{what}: {err}")
    return CaptureError(
        f"{what} cannot be captured into a replayed graph: it reads the host (.item(), .cpu(),"
        " a branch on a tensor, a tensor made from Python numbers on the device, ...). Make it"
        f" capturable, or run inside disable_graphs(). ({err})")


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


class _DirectCollectives(TorchDispatchMode):
    """Active while a mesh route captures: a collective that reaches
    ``torch.distributed`` other than through ``ops/sharding.py::_collective``
    (whose collectives become cuts) raises :class:`CaptureError` naming it —
    gloo would wait on the host inside the capture, and NCCL would be
    captured into the graph, out of ``collective_stats``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            raise CaptureError(
                f"torch.distributed's {func} was called inside a replayed step, not through "
                "ops/sharding.py::_collective (all_gather, all_gather_rows, all_gather_cols, "
                "all_reduce), whose collectives the replays run between the step's graphs. "
                "Call those, or run inside disable_graphs().")
        return func(*args, **(kwargs or {}))


def _calls() -> int:
    """The collectives ``_collective`` has run so far (every kind)."""
    return sum(v for k, v in collective_stats.items() if k.endswith("_calls"))


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
    and live times; ``active_n`` the route's live count (None without).
    ``record(t, out)``, where given, writes a step's outputs (``out``, a
    ``BatchedPFOut`` of buffer views) at its live time t (a (1,) int64
    tensor) into stores of its own."""

    def __init__(self, models, params, cloud, log_w, y, capacity: int, active_n=None,
                 record=None):
        self.active_n = active_n
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
        1 − k at the route's live count, adding its evidence to log Z: the
        body a graph captures."""
        t = self.times.index_select(0, self.pos)
        y_t = self.y.index_select(0, t).reshape(())
        self.pos.add_(1)
        out = _bf.batched_pf_step(generator, self.model, _bf.from_cloud(self.clouds[k]),
                                  self.log_w[k], y_t, config, self.params, self.active_n,
                                  out=(self.clouds[1 - k], self.log_w[1 - k]))
        self.log_z.add_(out.log_mean)
        if self.record is not None:
            self.record(t, out)

    def result(self, k: int):
        """(particles (M, N, dx), log_w, log Z) of buffer k, as copies: the
        next call overwrites the buffers."""
        return _bf.from_cloud(self.clouds[k].clone()), self.log_w[k].clone(), self.log_z.clone()


class _ThetaBuffers:
    """The θ-level part of an online step's buffers (SMC²'s and IBIS's): log
    ω, log Z, the θ-ESS and its flag ESS < ``ess_min``, the acceptance rate,
    y, the position counter (the state's t), the StepInfo stores (ESS,
    acceptance rate, evidence increment, by t) and the pinned buffer of the
    host's flag read. Built like the state ``state`` it first holds, with
    ``capacity`` ≥ len(y)."""

    def __init__(self, state, y, capacity: int, ess_min: float):
        device = state.theta.device
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

    def _load_theta(self, state, y) -> None:
        """Copy the state's θ-level tensors in, t into the position counter,
        its ESS flag, and y where given."""
        self.log_omega.copy_(state.log_omega)
        self.log_z.copy_(state.log_z)
        self.ess.copy_(state.ess)
        self.acc_ratio.copy_(state.acc_ratio)
        torch.lt(self.ess, self.ess_min, out=self.flag)
        self.pos.fill_(state.t)
        if y is not None:
            self.y[:y.shape[0]].copy_(y)

    def y_t(self) -> torch.Tensor:
        """The observation at the position counter (0-dim)."""
        return self.y.index_select(0, self.pos).reshape(())

    def _account(self, log_mean) -> None:
        """The θ-level part of a step whose per-θ evidence is ``log_mean``:
        log ω and log Z, the θ-ESS and its flag, the StepInfo fields into
        the stores at t; t advanced."""
        t = self.pos
        prev_lse = torch.logsumexp(self.log_omega, dim=0)
        self.log_omega.add_(log_mean)
        ess = ess_from_log_weights(self.log_omega)
        self.ess.copy_(ess)
        self.log_z.add_(log_mean)
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

    def infos(self, first: int, last: int) -> dict:
        """The StepInfo stores of the steps at t ∈ [first, last), as copies."""
        return {name: store[first:last].clone() for name, store in self.stores.items()}


class OnlineBuffers(_ThetaBuffers):
    """Everything SMC²'s captured online step reads and writes: the θ-level
    buffers (:class:`_ThetaBuffers`), θ and the exchange's pending flag (a
    collector's state holds them), the θ bank's model and kernel
    parameters, two clouds and two log-weight planes, and with ``collect``
    (a :class:`_Collector`) the collector's stores; ``active_n`` the
    route's live count (None outside "full" padding); ``rows``: this rank's
    rows of the θ bank on a mesh (None without), whose per-θ evidence the
    step gathers whole."""

    def __init__(self, models, params, state, y, capacity: int, ess_min: float, active_n=None,
                 rows=None):
        super().__init__(state, y, capacity, ess_min)
        self.active_n, self.rows = active_n, rows
        cloud = _bf.as_cloud(state.particles)
        self.theta = torch.empty_like(state.theta)
        self.pending = torch.zeros((), dtype=torch.bool, device=cloud.device)
        self.model = _tree_buffers(models)
        self.params = None if params is None else torch.empty_like(params)
        self.clouds = (torch.empty_like(cloud), torch.empty_like(cloud))
        self.log_w = (torch.empty_like(state.log_w), torch.empty_like(state.log_w))
        self.collect = None

    def load(self, models, params, state, y=None) -> None:
        """Copy the state in (its clouds into buffer 0, θ, its θ-level
        tensors, its pending flag, its bank's fields and kernel parameters),
        and y where given: the same with a collector or without."""
        _load_model(self, models, params)
        self.clouds[0].copy_(_bf.as_cloud(state.particles))
        self.log_w[0].copy_(state.log_w)
        self.theta.copy_(state.theta)
        self.pending.fill_(state.exchange_pending)
        self._load_theta(state, y)

    def step(self, generator, config, k: int) -> None:
        """The online step after the rejuvenation decision, from buffer k
        into buffer 1 − k at the route's live count ≡ ``SMC2.step``'s, then
        the collector: the body a graph captures."""
        out = _bf.batched_pf_step(generator, self.model, _bf.from_cloud(self.clouds[k]),
                                  self.log_w[k], self.y_t(), config, self.params, self.active_n,
                                  out=(self.clouds[1 - k], self.log_w[1 - k]))
        self._account(all_gather_rows(out.log_mean, self.rows))
        if self.collect is not None:
            self.collect(self, 1 - k)

    def fields(self, k: int) -> dict:
        """The state's tensors that the step writes, as views of buffer k."""
        return {"particles": _bf.from_cloud(self.clouds[k]), "log_w": self.log_w[k],
                "log_omega": self.log_omega, "log_z": self.log_z, "ess": self.ess}


class IBISBuffers(_ThetaBuffers):
    """Everything IBIS's captured online step reads and writes: the θ-level
    buffers (:class:`_ThetaBuffers`), the θ bank's model and two Kalman
    (mean, cov) banks — this rank's rows of them on a mesh (``rows``, None
    without), whose log-likelihoods the step gathers whole."""

    def __init__(self, models, state, y, capacity: int, ess_min: float, rows=None):
        super().__init__(state, y, capacity, ess_min)
        self.rows = rows
        self.model = _tree_buffers(models)
        self.mean = (torch.empty_like(state.mean), torch.empty_like(state.mean))
        self.cov = (torch.empty_like(state.cov), torch.empty_like(state.cov))

    def load(self, models, state, y=None) -> None:
        """Copy the state in (its Kalman bank into buffer 0, its θ-level
        tensors, its bank's fields), and y where given."""
        _tree_load(self.model, models)
        self.mean[0].copy_(state.mean)
        self.cov[0].copy_(state.cov)
        self._load_theta(state, y)

    def step(self, k: int) -> None:
        """IBIS's online step after the rejuvenation decision, from buffer k
        into buffer 1 − k ≡ ``IBIS.step``'s: the Kalman update at y_t, then
        the θ-level part. The body a graph captures."""
        out = _kf.kalman_step(self.model, _kf.KalmanState(self.mean[k], self.cov[k]), self.y_t())
        self.mean[1 - k].copy_(out.state.mean)
        self.cov[1 - k].copy_(out.state.cov)
        self._account(all_gather_rows(out.log_lik, self.rows))

    def fields(self, k: int) -> dict:
        """The state's tensors that the step writes, as views of buffer k."""
        return {"mean": self.mean[k], "cov": self.cov[k], "log_omega": self.log_omega,
                "log_z": self.log_z, "ess": self.ess}


class _Collector:
    """SMC²'s ``collect_fn`` inside the online step, as JAX traces it into
    its scan: called on the state the step just wrote — views of the
    buffers, ``t`` the position counter as a 0-dim int64 tensor and
    ``exchange_pending`` the pending flag as a 0-dim bool tensor (the
    arrays JAX traces), ``active_n`` the route's — its outputs' leaves
    written into (capacity, …) stores at the step's t. The stores take
    their leaves' shapes from the first call (the route's warm-up). One
    that reads the host raises :class:`CaptureError` naming it, as does a
    leaf that is not a tensor on the route's device."""

    def __init__(self, fn, template, capacity: int, device):
        self.fn, self.template, self.capacity, self.device = fn, template, capacity, device
        self.name = f"collect_fn {_name(fn)!r}"
        self.tree = self.stores = None

    def __call__(self, b: OnlineBuffers, k: int) -> None:
        view = replace(self.template, theta=b.theta, acc_ratio=b.acc_ratio, t=b.pos.reshape(()),
                       exchange_pending=b.pending, **b.fields(k))
        try:
            out = self.fn(view)
        except RuntimeError as err:
            refusal = capture_error(err, self.name, self.device)
            if refusal is None:
                raise
            raise refusal from err
        leaves = _leaves(out)
        if self.stores is None:
            _on_device(leaves, self.device, self.name)
            self.tree = out
            self.stores = [torch.empty((self.capacity,) + tuple(x.shape), dtype=x.dtype,
                                       device=self.device) for x in leaves]
        t = b.pos - 1
        for store, value in zip(self.stores, leaves, strict=True):
            store.index_copy_(0, t, value.unsqueeze(0))

    def series(self, first: int, last: int) -> list:
        """The stored leaves of the steps at t ∈ [first, last), as copies."""
        return [store[first:last].clone() for store in self.stores]


class _Route:
    """A captured route: its buffers, its body ``body(generator, k)``, its
    generator, its graphs by (first buffer, steps) (None until captured)
    and each graph's launches; ``k``, the buffer that holds the last step's
    output; ``replays``, its graph launches (where it has no graphs, its
    bodies' runs grouped as the graphs would launch them). A filter's route
    (``period`` 2) captures one step from either buffer and, with ``multi``,
    also :data:`STEPS_PER_GRAPH` steps from buffer 0; a sweep's (``period``
    1) one body, whose outputs (``out``: what the body returned at capture,
    or at its last eager run) each replay rewrites in place. ``runs_eigh``:
    the warm-up's body ran ``torch.linalg.eigh``; ``graphed``: the route
    replays graphs (on the card, unless ``runs_eigh``), else it runs its
    bodies eagerly through the buffers. ``timing``: the seconds of the
    warm-up, of the capture (the body's issue into the graphs) and of the
    instantiation.

    Cuts: a collective of the body (``ops/sharding.py::_collective``, a
    mesh route's gathers) ends a graph. Each graph is a list of segments,
    the body's launches between two collectives, and the collectives
    between them, recorded at capture (no collective runs there: the input
    holds no values yet) with their input and output tensors, which the
    route keeps alive: the next segment reads the output. A replay runs
    segment 0, collective 0, segment 1, … through ``_collective``, eagerly,
    so ``collective_stats`` counts what the eager loop counts. ``cuts``: the
    collectives a step (those of the warm-up's step; the capture must record
    as many). A route whose step has a cut replays one step a launch (no
    S-step graph). ``segment_replays``: the segments launched (where it has
    no graphs, as the graphs would launch them). ``mesh``: on a mesh route a
    collective that reaches ``torch.distributed`` other than through
    ``_collective`` raises :class:`CaptureError` at capture, naming it."""

    def __init__(self, buffers, body, device, multi: bool, period: int = 2, mesh=None):
        self.buffers, self.body, self.device = buffers, body, device
        self.multi, self.period, self.mesh = multi, period, mesh is not None
        self.generator = torch.Generator(device=device)
        self.graphs = None
        self.runs_eigh = self.graphed = False
        self.launches = {}
        self.k = 0
        self.replays = self.segment_replays = self.cuts = 0
        self.out = None
        self.timing = {}

    def load(self, *args) -> None:
        """Load the buffers (``buffers.load(*args)``); the next replay starts
        from buffer 0."""
        self.buffers.load(*args)
        self.k = 0

    def capture(self, generator, reload) -> None:
        """The warm-up (the body once eagerly, on the card on a side stream,
        then undone: the caller's generator state, the launch counters and
        ``collective_stats`` restored, ``reload()`` loading the buffers
        again; its collectives are the step's cuts), then, on the card, the
        graphs — unless the warm-up ran ``torch.linalg.eigh``, which checks
        its errors on the host (a capture refuses it): such a route, as
        every route on the CPU, runs its bodies eagerly. In the span
        ``smc.capture``; counted in :data:`graph_stats`."""
        with named_scope("smc.capture"):
            self._capture(generator, reload)
        graph_stats["captures"] += 1
        for part, seconds in self.timing.items():
            graph_stats[part] += seconds

    def _capture(self, generator, reload) -> None:
        cuda = self.device.type == "cuda"
        before, eighs = launch_counts(), eigh.calls
        stats, calls = collections.Counter(collective_stats), _calls()
        drawn = None if generator is None else generator.get_state()
        t0 = time.perf_counter()
        if cuda:
            side, main = torch.cuda.Stream(device=self.device), torch.cuda.current_stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.body(generator, 0)
            main.wait_stream(side)
            torch.cuda.synchronize(self.device)
        else:
            self.body(generator, 0)
        timing = {"warmup_s": time.perf_counter() - t0, "capture_s": 0.0, "instantiate_s": 0.0}
        if drawn is not None:
            generator.set_state(drawn)
        set_launch_counts(before)
        self.cuts = _calls() - calls
        collective_stats.clear()  # the warm-up's collectives are not the run's
        collective_stats.update(stats)
        self.multi = self.multi and not self.cuts
        self.runs_eigh, eigh.calls = eigh.calls != eighs, eighs
        reload()
        if not cuda or self.runs_eigh:
            self.graphs, self.timing = {}, timing
            return
        global _pool
        if _pool is None:
            _pool = torch.cuda.graph_pool_handle()
        shapes = [(0, 1), (1, 1)] if self.period == 2 else [(0, 1)]
        if self.multi and STEPS_PER_GRAPH > 1:
            shapes.append((0, STEPS_PER_GRAPH))
        graphs, launches = {}, {}
        try:
            for k, steps in shapes:
                start = launch_counts()
                t0 = time.perf_counter()
                try:
                    segments, cuts, out, ends = self._capture_steps(k, steps)
                except RuntimeError as err:  # the body's own error, where it gave one
                    cause = err
                    while cause is not None and not isinstance(cause, CaptureError):
                        cause = cause.__context__
                    if cause is None or cause is err:
                        raise
                    raise CaptureError(str(cause)) from err
                if len(cuts) != steps * self.cuts:
                    raise RuntimeError(f"the capture of {steps} step(s) recorded {len(cuts)}"
                                       f" collectives; the warm-up's step ran {self.cuts}")
                timing["capture_s"] += time.perf_counter() - t0 - ends
                timing["instantiate_s"] += ends  # capture_end instantiates
                launches[(k, steps)] = [a - b for a, b in zip(launch_counts(), start)]
                graphs[(k, steps)] = (segments, cuts)
                if (k, steps) == (0, 1):
                    self.out = out
        finally:
            set_launch_counts(before)  # a capture launches nothing
        self.graphs, self.launches, self.timing = graphs, launches, timing
        self.graphed = True

    def _capture_steps(self, k: int, steps: int):
        """``steps`` steps from buffer k captured with
        ``capture_error_mode="global"`` (a host sync inside raises) on a side
        stream, as segments: at each collective the graph ends, the
        collective is recorded as a cut (``sharding.capture_cut``) and the
        next segment's graph begins in the same pool. Returns (the segments'
        graphs, the cuts' (op, out, x, group, name), the body's last return,
        the seconds of the graphs' instantiation)."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        segments, cuts, ends = [], [], [0.0]

        def begin():
            g = torch.cuda.CUDAGraph()
            g.register_generator_state(self.generator)
            g.capture_begin(pool=_pool, capture_error_mode="global")
            return g

        def end(g):
            t = time.perf_counter()
            g.capture_end()
            ends[0] += time.perf_counter() - t
            segments.append(g)

        def cut(op, out, x, group, name):
            end(graph[0])
            cuts.append((op, out, x, group, name))
            graph[0] = begin()
            return out

        with torch.cuda.stream(torch.cuda.Stream(device=self.device)):
            graph = [begin()]
            _sh.capture_cut = cut
            try:
                with _DirectCollectives() if self.mesh else contextlib.nullcontext():
                    for i in range(steps):
                        out = self.body(self.generator, (k + i) % 2)
            except BaseException:
                with contextlib.suppress(RuntimeError):  # the capture was invalidated
                    graph[0].capture_end()
                raise
            finally:
                _sh.capture_cut = None
            end(graph[0])
        return segments, cuts, out, ends[0]

    def _launch(self, generator, steps: int, times: int) -> None:
        """``times`` launches of the graph of ``steps`` steps from buffer
        ``self.k``, each its segments with its collectives between them
        (with no graphs, its bodies with ``generator``)."""
        k = self.k
        if self.graphed:
            segments, cuts = self.graphs[(k, steps)]
            for _ in range(times):
                segments[0].replay()
                for collective, g in zip(cuts, segments[1:]):
                    _sh._collective(*collective)
                    g.replay()
            add_launch_counts(self.launches[(k, steps)], times)
        else:
            for _ in range(times):
                for i in range(steps):
                    self.out = self.body(generator, (k + i) % 2)
        self.k = (k + steps * times) % self.period
        self.replays += times
        self.segment_replays += times * (steps * self.cuts + 1)
        graph_stats["replays"] += times * (steps * self.cuts + 1)
        graph_stats["replayed_steps"] += times * steps

    def replay(self, generator, steps: int) -> None:
        """``steps`` steps (a sweep route's: sweeps) from buffer ``self.k``
        with the caller's generator state: ⌊steps/S⌋ launches of the S-step
        graph (from buffer 0, on the routes that have one), then one launch
        a step. A route that draws nothing (a Kalman loop, IBIS's step)
        takes no generator (None)."""
        moved = self.graphed and generator is not None
        if moved:
            self.generator.set_state(generator.get_state())
        if self.multi and STEPS_PER_GRAPH > 1 and self.k == 0 and steps >= STEPS_PER_GRAPH:
            self._launch(generator, STEPS_PER_GRAPH, steps // STEPS_PER_GRAPH)
            steps %= STEPS_PER_GRAPH
        for _ in range(steps):
            self._launch(generator, 1, 1)
        if moved:
            generator.set_state(self.generator.get_state())


def _mesh_key(mesh, rows=None, cols=None):
    """A route's part of its key for ``mesh`` (None without): the mesh by
    identity (two meshes never share a route: a cut holds its group), this
    rank's rows (lo, hi, m, shards) and, where the mesh shards particles,
    its particles of each row (lo, hi, n, shards)."""
    if mesh is None:
        return None
    return (_Same(mesh), None if rows is None else tuple(rows[:4]),
            None if cols is None else tuple(cols[:4]))


def _key(models, params, cloud, y, config, capacity: int, active_n) -> tuple:
    """A filter step's part of a route's key; ``active_n`` the live count
    (None without): the graph holds it, and the buffers' shapes do not show
    it (it stays the key's last element). On a mesh, the cloud is this
    rank's rows (and particles) and the models the whole bank's; the mesh's
    part (:func:`_mesh_key`) before the live count."""
    mesh = _mesh_key(config.mesh, _bf._rows(config, cloud.shape[0]),
                     _bf._cols(config, cloud.shape[2]))
    return (config.algorithm, config.resampling, config.ess_threshold,
            _tree_key(config.proposal), _tree_key(models),
            None if params is None else tuple(params.shape), tuple(cloud.shape), cloud.dtype,
            cloud.device, y.dtype, capacity, mesh, active_n)


def _ready(key, make, load, generator) -> _Route:
    """The cached route of ``key`` (``make()`` where the cache has none),
    loaded by ``load(route)`` and captured where it was not yet; kept in the
    cache only once captured. In the span ``smc.route``."""
    with named_scope("smc.route"):
        route = _cache.pop(key, None)
        if route is None:
            route = make()
        load(route)
        if route.graphs is None:
            route.capture(generator, lambda: load(route))
        _cache[key] = route
        while len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)
            graph_stats["evictions"] += 1
        return route


def _filter_route(kind, generator, models, init, params, y, live, config, active_n=None,
                  record_for=None):
    cloud = _bf.as_cloud(init.particles)
    capacity = _capacity(y.shape[0])
    key = kind + _key(models, params, cloud, y, config, capacity, active_n)

    def make():
        buffers = StepBuffers(models, params, cloud, init.log_weights, y, capacity, active_n)
        if record_for is not None:
            buffers.record = record_for(buffers)
        cfg = _guarded(config, cloud.device)
        return _Route(buffers, lambda gen, k: buffers.step(gen, cfg, k), cloud.device, True,
                      mesh=config.mesh)

    return _ready(key, make, lambda route: route.load(models, params, init, y, live), generator)


def filter_live(generator, models, init, params, y, live, config, active_n=None):
    """The masked filter's steps at the live times ``live`` (a non-empty
    CPU int64 tensor), from the init ``init``, at the live count
    ``active_n`` (a host int, or None), by replaying the route's captured
    graphs (capturing them first where the cache has none). Returns
    (particles (M, N, dx), log_w (M, N), log Z (M,))."""
    route = _filter_route(("masked",), generator, models, init, params, y, live, config,
                          active_n)
    route.replay(generator, live.shape[0])
    return route.buffers.result(route.k)


def _on_device(leaves, device, what: str) -> None:
    """Raise :class:`CaptureError` naming ``what`` where a leaf of its
    outputs is not a tensor on ``device``: a replayed step cannot store it."""
    for leaf in leaves:
        if not (isinstance(leaf, torch.Tensor) and leaf.device == device):
            kind = (f"a tensor on {leaf.device}" if isinstance(leaf, torch.Tensor)
                    else f"a {type(leaf).__name__}")
            raise CaptureError(f"{what} returned {kind}, not a tensor on {device}: a"
                               " replayed step cannot store it")


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
    _on_device(leaves, device, repr(tag[-1]))
    capacity = _capacity(y.shape[0])

    def record_for(buffers):
        buffers.stores = [torch.empty((capacity,) + tuple(x.shape), dtype=x.dtype, device=device)
                          for x in leaves]

        def record(t, out):
            try:
                values = _leaves(emit(out))
            except RuntimeError as err:
                refusal = capture_error(err, repr(tag[-1]), device)
                if refusal is None:
                    raise
                raise refusal from err
            for store, value in zip(buffers.stores, values, strict=True):
                store.index_copy_(0, t, value.unsqueeze(0))
        return record

    live = torch.arange(1, y.shape[0])
    route = _filter_route(("stored",) + tuple(tag), generator, models, init, params, y, live,
                          config, record_for=record_for)
    for store, leaf in zip(route.buffers.stores, leaves):
        store[0].copy_(leaf)
    route.replay(generator, live.shape[0])
    t = y.shape[0]
    series = _rebuild(first, iter([store[:t].clone() for store in route.buffers.stores]))
    return route.buffers.result(route.k) + (series,)


def online_route(generator, sampler, state, y, collect_fn=None) -> _Route:
    """SMC²'s online route for the sampler's configuration at the state's
    shapes and, under "full" padding, its live count, with the state and y
    loaded (captured first where the cache has none); with ``collect_fn``
    the collector runs inside the step (:class:`_Collector`, which sees the
    route's live count), and the route is keyed by it. On a mesh the step
    gathers the θ group's evidence increments (a cut) before the θ-level
    part."""
    cfg = sampler.config
    models = sampler.model_fn(state.theta)
    params = _bf.kernel_params(models, cfg.inner)
    cloud = _bf.as_cloud(state.particles)
    capacity = _capacity(y.shape[0])
    active_n = sampler._active(state)
    key = (("online", cfg.ess_min, None if collect_fn is None else _Same(collect_fn))
           + _key(models, params, cloud, y, cfg.inner, capacity, active_n))

    def make():
        buffers = OnlineBuffers(models, params, state, y, capacity, cfg.ess_min, active_n,
                                sampler._rows)
        if collect_fn is not None:
            template = replace(state, theta=buffers.theta, acc_ratio=buffers.acc_ratio,
                               **buffers.fields(0))
            buffers.collect = _Collector(collect_fn, template, capacity, cloud.device)
        inner = _guarded(cfg.inner, cloud.device)
        return _Route(buffers, lambda gen, k: buffers.step(gen, inner, k), cloud.device, False,
                      mesh=cfg.inner.mesh)

    return _ready(key, make, lambda route: route.load(models, params, state, y), generator)


def ibis_route(sampler, state, y) -> _Route:
    """IBIS's online route for the sampler's configuration at the state's
    shapes, with the state and y loaded (captured first where the cache has
    none). Its step draws nothing: it takes no generator. On a mesh the
    bank's model is this rank's rows, and the step gathers the θ group's
    log-likelihoods (a cut) before the θ-level part."""
    models = sampler._models(state.theta)
    capacity = _capacity(y.shape[0])
    mesh = sampler.config.inner.mesh
    key = ("ibis", sampler.config.ess_min, _tree_key(models), tuple(state.mean.shape),
           tuple(state.cov.shape), state.mean.dtype, state.mean.device, y.dtype, capacity,
           _mesh_key(mesh, sampler._rows))

    def make():
        buffers = IBISBuffers(models, state, y, capacity, sampler.config.ess_min, sampler._rows)
        return _Route(buffers, lambda gen, k: buffers.step(k), state.mean.device, False,
                      mesh=mesh)

    return _ready(key, make, lambda route: route.load(models, state, y), None)


def _meta(obj):
    """A tree's tensors as tensors on the meta device (shapes only)."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_like(obj, device="meta")
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _meta(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return type(obj)(_meta(v) for v in obj)
    return obj


class KalmanBuffers:
    """Everything a captured Kalman step reads and writes: the bank's model
    fields, two (mean, cov) banks, log Z, y and, for the masked loop, the
    mask (mask > 0, as bool), at ``capacity`` ≥ len(y); the position
    counter; with ``stored``, the (capacity, …) stores of each step's mean,
    cov and log-likelihood. The banks' shapes are a step's outputs', from
    the step on the meta device."""

    def __init__(self, model, y, capacity: int, masked: bool, stored: bool):
        device = y.device
        meta = _meta(model)
        out = _kf.kalman_step(meta, _kf.kalman_init(meta), torch.empty((), dtype=y.dtype,
                                                                       device="meta"))
        mean, cov, ll = out.state.mean, out.state.cov, out.log_lik
        self.model = _tree_buffers(model)
        self.mean = tuple(torch.empty(mean.shape, dtype=mean.dtype, device=device)
                          for _ in range(2))
        self.cov = tuple(torch.empty(cov.shape, dtype=cov.dtype, device=device) for _ in range(2))
        self.log_z = torch.empty(torch.broadcast_shapes(model.R.shape, ll.shape), dtype=y.dtype,
                                 device=device)
        self.y = torch.zeros(capacity, device=device, dtype=y.dtype)
        self.mask = torch.zeros(capacity, device=device, dtype=torch.bool) if masked else None
        self.pos = torch.zeros(1, device=device, dtype=torch.int64)
        self.stores = ([torch.empty((capacity,) + tuple(x.shape), dtype=x.dtype, device=device)
                        for x in (mean, cov, ll)] if stored else None)

    def load(self, model, y, mask=None) -> None:
        """The bank's fields, (x0, Σ0) into buffer 0, log Z = 0, y, the
        mask (on y's device) where the loop has one, and the position back
        to the first."""
        _tree_load(self.model, model)
        init = _kf.kalman_init(model)
        self.mean[0].copy_(init.mean)
        self.cov[0].copy_(init.cov)
        self.log_z.zero_()
        self.y[:y.shape[0]].copy_(y)
        if self.mask is not None:
            torch.gt(mask, 0, out=self.mask[:mask.shape[0]])
        self.pos.zero_()

    def step(self, k: int) -> None:
        """One Kalman step at the position from buffer k into buffer 1 − k
        (``kalman.masked_step``: where the mask is False, the identity with
        ℓ = 0), ℓ added to log Z and stored where the route stores: the
        body a graph captures."""
        t = self.pos
        live = None if self.mask is None else self.mask.index_select(0, t).reshape(())
        mean, cov, ll = _kf.masked_step(self.model, self.mean[k], self.cov[k],
                                        self.y.index_select(0, t).reshape(()), live)
        self.mean[1 - k].copy_(mean)
        self.cov[1 - k].copy_(cov)
        self.log_z.add_(ll)
        if self.stores is not None:
            for store, value in zip(self.stores, (mean, cov, ll)):
                store.index_copy_(0, t, value.unsqueeze(0))
        self.pos.add_(1)

    def result(self, k: int):
        """((mean, cov), log Z) of buffer k, as copies: the next call
        overwrites the buffers."""
        return _kf.KalmanState(self.mean[k].clone(), self.cov[k].clone()), self.log_z.clone()


def _kalman_route(kind: str, model, y, mask=None, mesh=None) -> _Route:
    capacity = _capacity(y.shape[0])
    key = ("kalman", kind, _tree_key(model), y.dtype, y.device, capacity, _mesh_key(mesh))

    def make():
        buffers = KalmanBuffers(model, y, capacity, kind == "masked", kind == "stored")
        return _Route(buffers, lambda gen, k: buffers.step(k), y.device, True)

    return _ready(key, make, lambda route: route.load(model, y, mask), None)


def kalman_live(model, y, live: int, mesh=None):
    """The Kalman bank over y[0:live] (a host count), replayed: ⌊live/S⌋
    launches of the S-step graph and live mod S of one step; ``mesh``: the
    mesh whose rank holds the bank's rows (IBIS's), which keys the route.
    Returns ((mean, cov), log Z)."""
    route = _kalman_route("live", model, y, mesh=mesh)
    route.replay(None, live)
    return route.buffers.result(route.k)


def kalman_masked(model, y, mask):
    """The Kalman bank over all of y, the steps where ``mask`` (on y's
    device) is ≤ 0 the identity, replayed; the mask is not read on the
    host. Returns ((mean, cov), log Z)."""
    route = _kalman_route("masked", model, y, mask)
    route.replay(None, y.shape[0])
    return route.buffers.result(route.k)


def kalman_stored(model, y):
    """The Kalman bank over all of y, replayed, each step's mean, cov and
    log-likelihood stored: (means (T, …), covs (T, …), log-likelihoods
    (T, …)), as copies."""
    route = _kalman_route("stored", model, y)
    route.replay(None, y.shape[0])
    return tuple(store[:y.shape[0]].clone() for store in route.buffers.stores)


class _Same:
    """A key's part that equals only another of the same object (a
    function), which it holds alive: a graph reads the tensors that object
    built or holds at capture. A wrapper made by ``functools.wraps`` stands
    for the function it wraps (``__wrapped__``); a closure made again by the
    same ``def`` over the same objects (its code, globals, defaults and
    cells' contents, each by identity: ``examples/inflation.py``'s
    collector, made a run) stands for the first."""

    __slots__ = ("obj", "parts")

    def __init__(self, obj):
        self.obj = getattr(obj, "__wrapped__", obj)
        self.parts = (self.obj,)
        fn = self.obj
        if isinstance(fn, types.FunctionType) and fn.__closure__:
            try:
                self.parts = ((fn.__code__, fn.__globals__) + (fn.__defaults__ or ())
                              + tuple((fn.__kwdefaults__ or {}).values())
                              + tuple(c.cell_contents for c in fn.__closure__))
            except ValueError:  # a cell not yet filled
                pass

    def __eq__(self, other) -> bool:
        return (isinstance(other, _Same) and len(other.parts) == len(self.parts)
                and all(a is b for a, b in zip(self.parts, other.parts)))

    def __hash__(self) -> int:
        return hash(tuple(id(p) for p in self.parts))


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
            refusal = capture_error(err, what, device)
            if refusal is None:
                raise
            raise refusal from err
    return call


def _guarded(config, device):
    """``config`` with its proposal's step guarded (:func:`_guard`, naming
    it), as a route's body calls it."""
    p = config.proposal
    if p is None:
        return config
    return config._replace(proposal=Proposal(
        p.initial, _guard(p.step, f"the proposal's step {_name(p.step)!r}", device)))


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
