"""SMC² — online joint state + parameter inference (L3), counterpart of
``sequential_monte_carlo_tpu/samplers/smc2.py``: ``init``, ``step``,
``run`` and ``run_segmented``, the exchange step (Chopin's N-doubling) in
both padding policies, the resample-move core that density-tempered SMC
shares, and ``expected_parameters``.

The M inner particle filters are one batched (M, N) program
(``ops/batched_filter.py``). Where the JAX package compiles the whole run
into one ``lax.scan`` with ``lax.cond`` triggers, the port steps from the
host: one ``step`` per observation, which reads the θ-ESS flag on the host
to decide on a rejuvenation (and the acceptance rate, after one, to decide
on an exchange), and rejuvenations that filter the consumed prefix y[0:t]
only. On the card, where the inner filter's route is captured
(``batched_filter.captures``; on a mesh too), the step after the decision
is a CUDA-graph replay (``ops/graphs.py``, the counterpart of
``_step_jit``): ``run`` / ``run_segmented`` keep the state in the route's
buffers between steps, read one flag a step through a pinned buffer, run a
rejuvenation eagerly between replays (its masked filters replay their own
graphs) and copy the state out at the end, at a ``max_steps`` bound and
where a doubling changes N; ``step`` loads the state, replays and returns a
state that owns its arrays. Under "full" padding each live count has its
own routes (the graph holds the count): where the exchange doubles
``active_n`` inside a step, its refilter replays the new count's masked
route, and the step loads the state into the new count's online route
before it replays — the counterpart of the ``lax.cond`` that JAX traces
into its compiled step. ``collect_fn`` is captured into the replayed
step, as JAX traces it into its scan: it sees ``t`` and
``exchange_pending`` as device tensors (on both paths), and its outputs
are stored on the device at each step. Inside ``disable_graphs()`` every
step is the eager loop, bit for bit the same. Randomness comes from one
explicit ``torch.Generator`` on the device of the data.

The exchange step (``acc_threshold > 0``, ≡ the reference's ``exchange!``):
right after a rejuvenation whose acceptance rate fell below
``acc_threshold``, while N ≤ ``exchange_max_n``, N doubles, the consumed
history is refiltered at the doubled N for every θ, and the θ-weights are
corrected by new log Z − old log Z. ``SMCConfig.elastic_pad`` picks how:

- ``"grow"`` (default): the arrays stay at the live N; the step raises
  ``state.exchange_pending`` and finishes at the old N, and
  :meth:`SMC2.maybe_exchange` (or :meth:`SMC2.run_segmented`, after each
  step) re-pads to 2N and refilters — the JAX package's
  ``step()`` + ``maybe_exchange`` timing. Until a doubling fires, a run is
  bitwise the run without the exchange step.
- ``"full"``: the arrays are padded once to the doubling cap, and the live
  count ``state.active_n`` doubles inside the step, right after the
  rejuvenation, with the refilter at the padded shape; slots past it hold
  log-weight −inf.

θ-sharding (``config.inner.mesh``, ``parallel.ShardedSMC2``): every rank
runs this program in lockstep. The θ-level state (θ, log ω, log Z, ESS, the
acceptance rate, t) is whole on every rank and the clouds (``particles``,
``log_w``) hold the rank's rows [r·M/R, (r+1)·M/R). The filters return the
rank's rows, and one ``all_gather`` a event makes their per-row numbers
whole: the evidence increments of an online step, the log-likelihoods of a
rejuvenation's proposals (after its whole masked filter) and of a refilter.
A θ-resample gathers the clouds whole and keeps the ancestors' rows of this
rank. Every draw is made at the whole bank's shape from the generator all
ranks hold alike, and the gathers are exact, so the host's decisions (the
θ-ESS, the exchange test) read the same values on every rank and a sharded
run equals the unsharded one bit for bit.

Particle-axis sharding (a mesh with ``particle`` = Rp > 1): the clouds hold
the rank's particles [b·N/Rp, (b+1)·N/Rp) of its rows, and the filters
make every per-row number (log-mean, ESS) whole and the same bits on every
rank of the particle group (``ops/batched_filter.py``), so θ, log ω, log Z,
the ESS and the MH decisions are too. ``_whole`` gathers over the θ group
only (the ranks of this rank's particle column): a θ-resample gives each
rank all M rows of its particle slice and keeps its ancestors' rows of it.
N (and, in "full" padding, the doubling cap) is split over the particle
ranks; the live prefix may lie wholly inside the first ranks' slices. The
split sums round otherwise than one rank's, so such a run is close to the
unsharded one, not bitwise equal to it.

On a mesh the loops replay as without one (``ops/graphs.py``): the masked
filter of a θ-only mesh has no collective and replays S steps a launch;
a step that gathers (the online step's evidence increments, a particle
group's rows) replays as graphs with the collectives run eagerly between
them, one step a launch. The glue between replays (``_whole`` of a
rejuvenation's log Z, the θ-resample's gathers) stays eager.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops import batched_filter as _bf
from ..ops import graphs
from ..ops.batched_filter import (
    as_cloud,
    batched_log_likelihood_masked,
    batched_pf_init,
    batched_pf_step,
    from_cloud,
)
from ..ops.resampling import get_resampler
from ..ops.sharding import all_gather_rows, local_rows, particle_shards, theta_rows
from ..ops.weights import ess_from_log_weights
from ..utils.profiling import named_scope
from ..utils.struct import replace
from .base import SMC2State, SMCConfig, StepInfo
from .kernels import anneal_scales, kernel_chol, propose, rw_kernel_cov


def expected_parameters(state) -> torch.Tensor:
    """ω-weighted posterior mean of θ (of an SMC² or IBIS state)."""
    return torch.softmax(state.log_omega, dim=0) @ state.theta


def _tuple_like(like: tuple, fields: list) -> tuple:
    return type(like)(*fields) if hasattr(like, "_fields") else tuple(fields)


def _stack(items: list):
    """Per-step outputs — tensors, or dicts and (named) tuples of them —
    stacked over the steps."""
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    if isinstance(items[0], tuple):
        return _tuple_like(items[0], [_stack(list(f)) for f in zip(*items)])
    return torch.stack([torch.as_tensor(x) for x in items])


def _first(tree, k: int):
    """The first k steps of stacked outputs."""
    if isinstance(tree, dict):
        return {key: _first(v, k) for key, v in tree.items()}
    if isinstance(tree, tuple):
        return _tuple_like(tree, [_first(f, k) for f in tree])
    return tree[:k]


class SMC2:
    """Online SMC² sampler.

    Parameters
    ----------
    model_fn : θ (M, dθ) → batched model (e.g. ``ucsv_model``).
    prior : distribution over θ with sample/log_prob/in_support.
    config : SMCConfig.

    Usage::

        sampler = SMC2(ucsv_model, prior, SMCConfig(1024, 512, 5, 0.5))
        gen = torch.Generator(device).manual_seed(0)
        state, infos = sampler.run(gen, y)   # y on the device

    or step by step, with the exchange step's doublings serviced between
    steps::

        state = sampler.init(gen, y)
        for _ in range(1, len(y)):
            state, info = sampler.step(gen, state, y)
            state = sampler.maybe_exchange(gen, state, y, info)
    """

    def __init__(self, model_fn: Callable, prior,
                 config: SMCConfig = SMCConfig()):
        if config.elastic_pad not in ("grow", "full"):
            raise ValueError(f"elastic_pad must be 'grow' or 'full', got {config.elastic_pad!r}")
        self.model_fn = model_fn
        self.prior = prior
        self.config = config
        self._elastic = config.acc_threshold > 0.0
        self._grow = self._elastic and config.elastic_pad == "grow"
        # the filters take a live count only where it can differ from the
        # array size: "full" padding, arrays at the doubling cap
        self._use_active = self._elastic and not self._grow
        n_pad = config.n_particles
        if self._use_active:
            while n_pad <= config.exchange_max_n:
                n_pad *= 2
        self._n_pad = n_pad
        # this rank's rows of the θ-bank under config.inner.mesh, and the
        # number of ranks that split each row's particles
        self._rows = theta_rows(config.inner.mesh, config.n_theta)
        self._particle_shards = particle_shards(config.inner.mesh)
        if n_pad % self._particle_shards:
            raise ValueError(f"N = {n_pad} particles do not split over "
                             f"{self._particle_shards} particle shards")

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a per-row quantity, gathered whole."""
        return all_gather_rows(x, self._rows)

    def _mine(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole per-row quantity."""
        return local_rows(x, self._rows)

    def _active(self, state: SMC2State):
        return state.active_n if self._use_active else None

    def _n(self, state: SMC2State) -> int:
        """The whole rows' particle count of the state's clouds."""
        return state.particles.shape[1] * self._particle_shards

    def init(self, generator, y) -> SMC2State:
        """Draw the θ-cloud from the prior and assimilate y[0] for every θ
        (at the padded N under ``elastic_pad="full"``). In the span
        ``smc.init``."""
        cfg = self.config
        with named_scope("smc.init"):
            theta = self.prior.sample(generator, (cfg.n_theta,))
            outs = batched_pf_init(generator, self.model_fn(theta), self._n_pad, cfg.n_theta,
                                   y[0], cfg.inner,
                                   cfg.n_particles if self._use_active else None)
            log_mean = self._whole(outs.log_mean)
            return SMC2State(
                theta=theta,
                log_omega=log_mean,
                particles=outs.particles,
                log_w=outs.log_weights,
                log_z=log_mean,
                ess=ess_from_log_weights(log_mean),
                acc_ratio=torch.zeros((), device=theta.device),
                t=1,
                active_n=cfg.n_particles,
                exchange_pending=False,
            )

    def _resample_theta(self, generator, state: SMC2State) -> SMC2State:
        """Multinomial resample of the θ-particles, co-indexing their clouds
        and running log Z (under θ-sharding the clouds are gathered whole and
        each rank keeps its rows' ancestors)."""
        w = torch.softmax(state.log_omega, dim=0)
        a = get_resampler(self.config.theta_resampling)(generator, w).long()
        mine = self._mine(a)
        return replace(
            state,
            theta=state.theta[a],
            particles=from_cloud(self._whole(as_cloud(state.particles))[mine]),
            log_w=self._whole(state.log_w)[mine],
            log_z=state.log_z[a],
            log_omega=torch.zeros_like(state.log_omega),
        )

    def _rejuvenate(self, generator, state: SMC2State, y, mask,
                    xi: float = 1.0) -> SMC2State:
        """``chain`` PMMH moves with annealed RW proposals; each re-runs the
        inner filter over the masked history for all M proposals at once."""
        cfg = self.config
        m, n = cfg.n_theta, self._n(state)
        theta, log_z = state.theta, state.log_z
        cloud, log_w = as_cloud(state.particles), state.log_w
        accepted = torch.zeros(m, dtype=torch.bool, device=theta.device)
        chol = kernel_chol(rw_kernel_cov(theta, cfg))
        for scale in anneal_scales(cfg):
            theta_prop = propose(generator, theta, chol, scale)
            ok = self.prior.in_support(theta_prop)
            # run the filter at a safe θ where the proposal left the support
            # (its result is discarded by the accept select)
            theta_safe = torch.where(ok[:, None], theta_prop, theta)
            new_p, new_lw, logz_prop = batched_log_likelihood_masked(
                generator, self.model_fn(theta_safe), n, m, y, mask, cfg.inner,
                self._active(state)
            )
            logz_prop = self._whole(logz_prop)
            lp_prop = self.prior.log_prob(theta_prop)
            lp_curr = self.prior.log_prob(theta)
            log_ratio = xi * (logz_prop - log_z) + (lp_prop - lp_curr)
            guard = (logz_prop + lp_prop) > -torch.inf
            log_u = torch.log(torch.rand(m, generator=generator,
                                         device=theta.device))
            accept = ok & guard & (log_u < log_ratio)
            theta = torch.where(accept[:, None], theta_prop, theta)
            mine = self._mine(accept)
            cloud = torch.where(mine[:, None, None], as_cloud(new_p), cloud)
            log_w = torch.where(mine[:, None], new_lw, log_w)
            log_z = torch.where(accept, logz_prop, log_z)
            accepted = accepted | accept
        return replace(
            state,
            theta=theta,
            particles=from_cloud(cloud),
            log_w=log_w,
            log_z=log_z,
            log_omega=torch.zeros_like(state.log_omega),
            # filled on the device: a tensor made from a host number there
            # would wait for the device (a host sync each rejuvenation)
            ess=torch.full((), float(m), device=theta.device),
            acc_ratio=torch.mean(accepted.to(theta.dtype)),
        )

    def _resample_move(self, generator, state: SMC2State, y, mask,
                       xi: float = 1.0) -> SMC2State:
        """θ-resample followed by tempered rejuvenation — the resample-move
        core shared by SMC² (ξ = 1) and density-tempered SMC. In the span
        ``smc.rejuvenate``."""
        with named_scope("smc.rejuvenate"):
            state = self._resample_theta(generator, state)
            return self._rejuvenate(generator, state, y, mask, xi)

    def _refilter(self, generator, state: SMC2State, y, mask, n: int,
                  active_n=None) -> SMC2State:
        """Fresh inner filters for every θ over the masked history at N = n
        (live count ``active_n``), and the θ-weights corrected by new log Z −
        old log Z."""
        cfg = self.config
        particles, log_w, log_z = batched_log_likelihood_masked(
            generator, self.model_fn(state.theta), n, cfg.n_theta, y, mask, cfg.inner,
            active_n)
        log_z = self._whole(log_z)
        log_omega = log_z - state.log_z
        return replace(state, particles=particles, log_w=log_w, log_z=log_z,
                       log_omega=log_omega, ess=ess_from_log_weights(log_omega))

    def _exchange(self, generator, state: SMC2State, y, mask) -> SMC2State:
        """The exchange step right after a rejuvenation ≡ the JAX package's
        ``_exchange_ingraph``: if the acceptance rate fell below
        ``acc_threshold`` while N ≤ ``exchange_max_n``, raise
        ``exchange_pending`` ("grow"), or double ``active_n`` and refilter
        the consumed history at the padded shape ("full"). Reads the
        acceptance rate on the host; draws nothing unless it fires."""
        cfg = self.config
        if not (state.acc_ratio.item() < cfg.acc_threshold
                and state.active_n <= cfg.exchange_max_n):
            return state
        if self._grow:
            return replace(state, exchange_pending=True)
        active2 = 2 * state.active_n
        return replace(self._refilter(generator, state, y, mask, self._n_pad, active2),
                       active_n=active2)

    def _graphed(self, state: SMC2State) -> bool:
        """Whether the online steps replay a captured route: the inner
        filter's route is captured (``batched_filter.captures``), at the
        state's live count under "full" padding."""
        return _bf.captures(self.config.inner, self._active(state), state.theta.device)

    @staticmethod
    def _owned(state: SMC2State) -> SMC2State:
        """The state with copies of the tensors that a later replay
        overwrites (views of an online route's buffers)."""
        return replace(state, particles=state.particles.clone(), log_w=state.log_w.clone(),
                       log_omega=state.log_omega.clone(), log_z=state.log_z.clone(),
                       ess=state.ess.clone())

    def _online_step(self, generator, route, state: SMC2State, y, collect_fn=None):
        """One online step on the captured route whose buffers hold
        ``state``: the step's one host read (the flag ESS < ess_min of the
        step or load before), the rejuvenation and the exchange test eagerly
        where it is set, their result loaded into the buffers — into the
        online route of the new live count (``collect_fn``'s), where the
        exchange doubled it under "full" padding — then one replay. Returns
        (the state after it, its stepped tensors views of the route's
        buffers; whether it rejuvenated; the route that stepped). In the
        span ``smc.online_step``."""
        with named_scope("smc.online_step"):
            degenerate = route.buffers.read_flag()
            if degenerate:
                mask = torch.arange(y.shape[0]) < state.t
                state = self._resample_move(generator, state, y, mask)
                if self._elastic:
                    state = self._exchange(generator, state, y, mask)
                if self._active(state) != route.buffers.active_n:
                    route = graphs.online_route(generator, self, state, y, collect_fn)
                else:
                    models = self.model_fn(state.theta)
                    route.load(models, _bf.kernel_params(models, self.config.inner), state)
            route.replay(generator, 1)
            return (replace(state, t=state.t + 1, **route.buffers.fields(route.k)), degenerate,
                    route)

    def step(self, generator, state: SMC2State, y):
        """One online assimilation step of y[state.t]; rejuvenates first
        when the θ-ESS fell below ``ess_min`` (then, with the exchange step
        on, the exchange). On a captured route (:meth:`_graphed`) the step
        after the decision is a graph replay — on the route of the live
        count after the exchange, under "full" padding — and the state
        returned owns its arrays. Returns (state, StepInfo). The eager step
        runs in the span ``smc.online_step``, as :meth:`_online_step` does."""
        if self._graphed(state):
            t = state.t
            route = graphs.online_route(generator, self, state, y)
            state, degenerate, route = self._online_step(generator, route, state, y)
            state = self._owned(state)
            incr = route.buffers.infos(t, t + 1)["log_evidence_incr"]
            return state, StepInfo(ess=state.ess, rejuvenated=torch.tensor(degenerate),
                                   acc_ratio=state.acc_ratio, log_evidence_incr=incr[0])
        with named_scope("smc.online_step"):
            cfg = self.config
            degenerate = bool(state.ess < cfg.ess_min)  # host sync
            if degenerate:
                mask = torch.arange(y.shape[0]) < state.t
                state = self._resample_move(generator, state, y, mask)
                if self._elastic:
                    state = self._exchange(generator, state, y, mask)

            outs = batched_pf_step(generator, self.model_fn(state.theta),
                                   state.particles, state.log_w, y[state.t],
                                   cfg.inner, active_n=self._active(state))
            log_mean = self._whole(outs.log_mean)
            prev_lse = torch.logsumexp(state.log_omega, dim=0)
            log_omega = state.log_omega + log_mean
            ess = ess_from_log_weights(log_omega)
            state = replace(
                state,
                log_omega=log_omega,
                particles=outs.particles,
                log_w=outs.log_weights,
                log_z=state.log_z + log_mean,
                ess=ess,
                t=state.t + 1,
            )
            info = StepInfo(
                ess=ess,
                rejuvenated=torch.tensor(degenerate),
                acc_ratio=state.acc_ratio,
                log_evidence_incr=torch.logsumexp(log_omega, dim=0) - prev_lse,
            )
            return state, info

    def _service_exchange(self, generator, state: SMC2State, y) -> SMC2State:
        """A pending doubling ("grow"): refilter the consumed history at 2N
        (fresh filters, so the old arrays need no re-padding) and correct
        the θ-weights."""
        n2 = 2 * self._n(state)
        mask = torch.arange(y.shape[0]) < state.t
        return replace(self._refilter(generator, state, y, mask, n2),
                       active_n=n2, exchange_pending=False)

    def maybe_exchange(self, generator, state: SMC2State, y, info=None) -> SMC2State:
        """≡ the reference's ``exchange!`` between steps: with
        ``elastic_pad="grow"``, service the doubling that the last step's
        exchange raised; otherwise (no exchange step, or "full" padding,
        whose doubling ran inside the step) the state as it is. ``info`` is
        taken for the JAX package's signature and not read."""
        if self._grow and state.exchange_pending:
            return self._service_exchange(generator, state, y)
        return state

    @staticmethod
    def _collected(state: SMC2State) -> SMC2State:
        """The state a collector sees on the eager path: ``t`` and
        ``exchange_pending`` as 0-dim device tensors (int64, bool), as on
        the captured route and as JAX traces them."""
        device = state.theta.device
        return replace(state, t=torch.full((), state.t, dtype=torch.int64, device=device),
                       exchange_pending=torch.full((), state.exchange_pending, dtype=torch.bool,
                                                   device=device))

    def run(self, generator, y, collect_fn: Callable | None = None):
        """Whole-sequence online run: ``init`` then ``step`` over y[1:],
        servicing the doublings in "grow" mode (:meth:`run_segmented`
        without a bound). Returns (final state, StepInfo of per-step
        tensors stacked over the T − 1 steps), or with ``collect_fn(state)``
        (state, (infos, series)), the series its outputs after each step
        stacked."""
        return self.run_segmented(generator, y, collect_fn=collect_fn)

    def run_segmented(self, generator, y, segment_size: int = 24,
                      collect_fn: Callable | None = None,
                      state: SMC2State | None = None, max_steps: int | None = None):
        """``run`` with checkpoint and resume ≡ the JAX package's
        ``run_segmented``: ``step`` over the observations, and in "grow"
        mode the service of a pending doubling after the step that raised
        it (``collect_fn`` sees the state before the service, as in JAX).

        ``state=``: continue a run (then the generator should be the one
        the run left off with); a doubling pending in it is serviced first.
        ``max_steps=``: stop after that many steps and return the mid-run
        state; a doubling raised by the last step stays pending in it, to be
        serviced on resume, so a split run with the same generator is
        bitwise the whole run. Returns (state, infos) or (state, (infos,
        series)) over the steps run in this call (zero of them past the
        bound). ``segment_size`` (≥ 1) sets the JAX package's dispatch
        segments; the port's host loop has no segments and does not read
        it beyond the check.

        ``collect_fn(state)`` → a tensor or a dict / (named) tuple of
        tensors, called after each step. As JAX traces it into its scan, the
        state's ``t`` and ``exchange_pending`` reach it as 0-dim tensors on
        the state's device (int64, bool), on the eager path too, so one
        collector serves both (index y with ``torch.take(y, state.t - 1)``,
        not ``y[state.t - 1]``, which reads t on the host). On a captured
        route (:meth:`_graphed`) it runs inside the replayed step, its
        outputs' leaves stored on the device at each step and copied out at
        the end: a collector that reads the host (``.item()``, a branch on
        a tensor, a tensor made from host values) or returns a leaf that is
        not a tensor on the state's device raises ``graphs.CaptureError``
        naming it, and is never run eagerly in its place. In the span
        ``smc.run`` (``utils/profiling.py``)."""
        if segment_size < 1:
            raise ValueError(f"segment_size must be ≥ 1, got {segment_size}")
        with named_scope("smc.run"):
            T = y.shape[0]
            if state is None:
                state = self.init(generator, y)
            elif self._grow and state.exchange_pending:
                state = self._service_exchange(generator, state, y)
            target = T if max_steps is None else min(T, state.t + max_steps)
            if state.t >= target:  # past the bound: zero steps, in the structure of a run's outputs
                out = _first(_stack([StepInfo(ess=state.ess, rejuvenated=torch.tensor(False),
                                              acc_ratio=state.acc_ratio,
                                              log_evidence_incr=torch.zeros_like(state.ess))]), 0)
                return state, (out if collect_fn is None
                               else (out, _first(_stack([collect_fn(self._collected(state))]), 0)))
            if self._graphed(state):
                state, out, series = self._run_graphed(generator, state, y, target, collect_fn)
                return state, (out if collect_fn is None else (out, series))
            infos, series = [], []
            while state.t < target:
                state, info = self.step(generator, state, y)
                infos.append(info)
                if collect_fn is not None:
                    series.append(collect_fn(self._collected(state)))
                mid_bound = state.t >= target and target < T
                if self._grow and state.exchange_pending and not mid_bound:
                    state = self._service_exchange(generator, state, y)
            out = _stack(infos)
            return state, (out if collect_fn is None else (out, _stack(series)))

    def _run_graphed(self, generator, state: SMC2State, y, target: int, collect_fn):
        """:meth:`run_segmented`'s steps up to ``target`` on the captured
        online route, the collector inside its step: the state stays in the
        route's buffers (a new route where a doubling changes N, or the live
        count under "full" padding) and is copied out at the end. Each
        route's stores hold the steps it ran: a doubling closes a chunk of
        them (the "full" doubling's own step is the new route's). Returns
        (state, StepInfo of the steps' stacked tensors, the collector's
        outputs stacked, or None)."""
        T = y.shape[0]
        route, first, chunks, fired = None, state.t, [], []

        def chunk(last):
            b = route.buffers
            chunks.append((b.infos(first, last), None if b.collect is None
                           else (b.collect.tree, b.collect.series(first, last))))

        while state.t < target:
            if route is None:
                route, first = graphs.online_route(generator, self, state, y, collect_fn), state.t
            t = state.t
            state, degenerate, stepped = self._online_step(generator, route, state, y,
                                                           collect_fn)
            if stepped is not route:  # "full": the live count doubled inside the step at t
                chunk(t)
                route, first = stepped, t
            fired.append(degenerate)
            mid_bound = state.t >= target and target < T
            if self._grow and state.exchange_pending and not mid_bound:
                chunk(state.t)
                state = self._service_exchange(generator, state, y)  # new arrays at 2N
                route = None
        if route is not None:
            chunk(state.t)
            state = self._owned(state)
        stores = {k: torch.cat([c[0][k] for c in chunks]) for k in chunks[0][0]}
        infos = StepInfo(ess=stores["ess"], rejuvenated=torch.tensor(fired),
                         acc_ratio=stores["acc_ratio"],
                         log_evidence_incr=stores["log_evidence_incr"])
        if collect_fn is None:
            return state, infos, None
        leaves = [torch.cat(parts) for parts in zip(*(c[1][1] for c in chunks))]
        return state, infos, graphs._rebuild(chunks[0][1][0], iter(leaves))
