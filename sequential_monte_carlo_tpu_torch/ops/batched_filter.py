"""Batched (θ-cloud-level) particle filtering — L2.5, counterpart of
``sequential_monte_carlo_tpu/ops/batched_filter.py``.

All M per-θ filters step as one (M, N) program. Every inner step is a
resample + ancestor gather and a propagate + reweight:

- Resample. Systematic and ``residual_systematic`` (pointwise the same
  scheme) by offsets u0 in K1 (``kernels/resample_walk.py``); stratified
  grids, and every elastic live-prefix grid, in K3
  (``kernels/resample_sorted.py``); ``multinomial``, ``residual`` and
  ``metropolis`` by their ancestors (``ops/resampling.py``) and a gather,
  plain tensor code, as the JAX package runs them on its XLA route.
- Propagate. The model's fused kernel (``kernels/propagate.py``, or
  ``kernels/ucsv.py`` on UC-SV's route without the normalize), whatever the
  resampling scheme; for a model without one (a DSL model), a draw from its
  transition and the observation density of the draw, plain tensor code over
  the models' distributions, as the JAX package's unfused route
  (:func:`propagate_reweight`, which the smoothers and conditional SMC call
  too); or, with a guided ``proposal``, the proposal's draw and the
  importance-corrected weight (plain tensor code, JAX's unfused route).

``PFConfig(resampling, ess_threshold, proposal, algorithm)``: the bootstrap
or guided filter, resampling at every step or where the ESS fell below
``ess_threshold``·N, or at ``ess_threshold`` 1 the auxiliary particle filter
(``algorithm="apf"``).

Auxiliary particle filter (Pitt & Shephard 1999), ≡ the JAX package's
``_batched_apf_step``: the first-stage weights look ahead through the
transition mean, λ = log w + log g(y | E[x′ | x]) (plain tensor glue over the
models' distributions); the resample draws ancestors by λ and gathers the
cloud with log g as one extra plane, so the ancestors' lookahead comes out
of the same launch; the model's step without the normalize gives the raw
log-weights of the propagated cloud, corrected by the ancestors' lookahead
and normalized here, with the evidence increment
log Σ exp(λ) + log mean exp(corr).

Adaptive resampling (``ess_threshold < 1``): a row fires when its ESS
1/Σw² falls below ``ess_threshold·N``. The step reads nothing on the host to
decide: it resamples and gathers every row, then keeps the gathered cloud and
the weights −log N on the rows that fired and the old cloud and log-weights
on the others (per-row selects on the device, the formulation the JAX
package's ``lax.cond`` is bitwise equal to). The carried log-weights ride
into the propagate kernel (``carry_logw``), whose normalize then gives the
evidence increment log Σ w·g directly.

Elastic live count (``active_n``, the padded form of SMC²'s N-doubling):
slots ≥ active_n carry log-weight −inf, the evidence normalizes by
active_n, the resample draws on the live prefix (:func:`_elastic_sorted_u`,
K3), the propagate runs on the kernel's route without the normalize (as the
JAX package's), and the increment is zeroed on the dead slots before the
normalize, so that no −inf + NaN reaches it.

Layout: particles are (M, N, dx) at the public functions, as in the JAX
package, but their storage is planar — the (M, dx, N) cloud that the
kernels read and write, seen through a transposed view (:func:`as_cloud`,
:func:`from_cloud`) — so no step copies the cloud between layouts.

θ-sharding (``config.mesh``, ``parallel.make_mesh``): the models are the
whole M-row bank, and the particles and log-weights this rank's rows
[r·M/R, (r+1)·M/R) (``ops/sharding.py``). Every draw is made at the whole
bank's shape from the generator that all ranks hold alike, and this rank
keeps its rows: the resample's draws and the CPU's normals are sliced, the
kernels take ``row_offset`` = r·M/R (their Philox stream is keyed by the
global row), and a draw through a distribution (the init, a model without a
kernel, a guided proposal, the metropolis resampler) runs on the rank's rows
tiled to M. So a sharded step computes, row for row, the unsharded step's
numbers, and needs no collective: its rows are independent. The price of
equal numbers: the resample's uniforms and, on the CPU, all the
(n_normals, M, N) normals are drawn at the whole bank on every rank, and a
draw through a distribution runs on the whole tiled bank, so those routes
cost every rank R times its rows' work and sharding saves none of it. Only
the kernel routes (K1/K3 and K2/K6 on the card) do a rank's rows alone.

Particle-axis sharding (a mesh with ``particle`` = Rp > 1, ≡ the JAX
package's ``parallel/collective.py::distributed_pf_step``, batched over the
rows): the particles and log-weights are this rank's slice [b·N/Rp,
(b+1)·N/Rp) of each of its rows (``ops/sharding.py``). The draws stay at
the whole bank's shape, and the rank keeps its rows and, where a draw is
per particle, its particles. A step:

- resample: one all_gather inside the particle group assembles each row's
  whole cloud and log-weights (the log-weights packed as one more plane,
  :func:`~.sharding.gather_row_cloud`); K1, or K3 on the window of a sorted
  grid, then writes only this rank's slots from the whole row, and the plain
  schemes take their ancestors over the whole row and keep the window;
- propagate: the model's kernel route without the normalize (K2's raw
  route, or K6 on UC-SV) on the rank's (m, C, N/Rp) slice, with
  ``particle_offset`` = b·N/Rp beside ``row_offset`` (the Philox counter is
  the global particle index); a draw through a distribution (a model
  without a kernel, a guided proposal) at the whole bank's shape, tiled along
  rows and particles, kept at the window;
- normalize: one all_gather inside the particle group assembles the rows'
  whole raw log-weights, and every rank normalizes whole rows as the
  unsharded step does (the kernel's normalize in its plain form,
  ``kernels/propagate.py::normalize_rows``, on the kernel route; else
  ``log_normalize``) and keeps its window. No sum over a row is split, so
  every rank of the group holds the same log-mean and ESS bit for bit, and
  on the CPU the run equals the unsharded one bit for bit. On the card the
  unsharded step normalizes inside K2, in another summation order, so there
  the two runs are close, not equal. The price: one plane of M·N
  log-weights more through the collective a step than a combine of per-rank
  partials would move, and each rank of the group normalizes the whole rows.

The masked filter (:func:`batched_log_likelihood_masked`, the samplers'
inner loop) replays its steps on the card from CUDA graphs where the route
is captured (:func:`captures`; :mod:`.graphs`: the port's form of the JAX
package's jitted masked scan), several steps a launch; so do SMC²'s online
step, ``filter_sequence`` and the smoothers' forward bank on the same
routes: every model (the plain propagate route of a DSL model too), proposal
and scheme, and the elastic ``active_n`` (one route per live count, which
the captured step holds as a host int), on a mesh too: a θ-only mesh's step
has no collective and replays as one process's does, and a particle mesh's
gathers are cuts between the step's graphs, run eagerly at each replay. The
eager loops run inside :func:`.graphs.disable_graphs`. Both give the same
bits.

Randomness: :func:`batched_pf_step` draws the resample's uniforms and, on a
GPU, one Philox seed for the propagate kernel (which draws its normals), on
the CPU the normals themselves, from an explicit ``torch.Generator``; the
rest of the step is :func:`_pf_step_from_draws`. The metropolis resampler, a
guided proposal and the propagate of a model without a kernel draw from the
generator there.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.propagate import normalize_rows
from ..kernels.resample_sorted import resample_gather_sorted, stratified_uniforms
from ..kernels.resample_walk import resample_gather
from ..utils.profiling import named_scope
from . import graphs
from .particle_filter import PFConfig
from .resampling import _inverse_cdf, _residual_from_uniforms, get_resampler, metropolis
from .sharding import (
    all_gather_cols,
    gather_row_cloud,
    local_cols,
    local_model,
    local_rows,
    particle_cols,
    particle_shards,
    theta_rows,
    theta_shards,
    tile_cols,
    tile_rows,
)
from .weights import log_normalize

__all__ = [
    "BatchedPFOut",
    "as_cloud",
    "from_cloud",
    "kernel_params",
    "propagate_reweight",
    "batched_pf_init",
    "batched_pf_step",
    "batched_log_likelihood_masked",
    "batched_log_likelihood",
]

# schemes resampled by offsets u0 (K1, or the elastic grid's offsets in K3)
_OFFSET_SCHEMES = ("systematic", "residual_systematic")


class BatchedPFOut(NamedTuple):
    particles: torch.Tensor  # (M, N, dx), planar storage
    log_weights: torch.Tensor  # (M, N) normalized per row
    log_mean: torch.Tensor  # (M,) incremental evidence per θ
    ess: torch.Tensor  # (M,)


def as_cloud(particles: torch.Tensor) -> torch.Tensor:
    """(M, N, dx) particles → the contiguous (M, dx, N) cloud; no copy when
    the storage is already planar."""
    return particles.transpose(1, 2).contiguous()


def from_cloud(cloud: torch.Tensor) -> torch.Tensor:
    """(M, dx, N) cloud → (M, N, dx) particles, as a view."""
    return cloud.transpose(1, 2)


def _has_kernel(models) -> bool:
    """Whether the models carry a fused propagate kernel (the zoo's
    families do, a DSL model does not)."""
    return hasattr(models, "fused_propagate_reweight")


def kernel_params(models, config: PFConfig = PFConfig()):
    """The step-invariant kernel parameters (``models.fused_params()``) of a
    filter run that propagates through the model's kernel; None for a
    guided proposal or a model without a kernel."""
    if config.proposal is None and _has_kernel(models):
        return models.fused_params()
    return None


def _whole_bank(states, rows, cols):
    """The (N, M, dx) states of this rank tiled to the whole bank's shape."""
    return tile_cols(states if rows is None else tile_rows(states, rows, 1), cols, 0)


def _mine(x, rows, cols):
    """This rank's rows (dim 1) and particles (dim 0) of an (N, M, ...) draw."""
    return local_cols(local_rows(x, rows, 1), cols, 0)


def propagate_reweight(models, y, cloud, draws, params=None, rows=None, cols=None, out=None):
    """Propagate + reweight the (M, dx, N) cloud without the normalize:
    (new cloud (M, dx, N), log g(y | x′) (M, N)). Through the model's kernel
    (``draws`` its Philox seed or normals, :func:`_draws`), or, for a model
    without one, by a draw from its transition on the (N, M, dx) view, the
    layout of the models' distributions, and the observation density of the
    draw (``draws`` the generator) — the JAX package's unfused route. With
    ``rows`` (θ-sharding), ``models`` is the whole bank, the cloud and
    ``params`` this rank's rows; with ``cols`` (particle sharding), the cloud
    is this rank's particles of them. ``out``: (new cloud, log-weights)
    buffers that the step writes (the captured step's, :mod:`.graphs`): the
    model's kernel in place, the plain route by a copy."""
    local = local_model(models, rows)
    if _has_kernel(models):
        return local.fused_propagate_reweight(y, cloud, params=params, normalize=False,
                                              out=out, **_propagate_draws(draws, rows, cols))
    states = cloud.permute(2, 0, 1)
    if rows is None and cols is None:
        x_new = models.transition_distribution(states).sample(draws)
    else:  # drawn at the whole bank's shape, kept at this rank's rows and particles
        x_new = _mine(models.transition_distribution(_whole_bank(states, rows, cols))
                      .sample(draws), rows, cols)
    incr = local.observation_distribution(x_new).log_prob(y)
    if out is None:
        return x_new.permute(1, 2, 0).contiguous(), incr.T.contiguous()
    return out[0].copy_(x_new.permute(1, 2, 0)), out[1].copy_(incr.T)


def _elastic_sorted_u(offsets: torch.Tensor, n: int, active_n: int) -> torch.Tensor:
    """The elastic filter's sorted grids over the live prefix ≡ the JAX
    package's ``_elastic_sorted_u``: u_i = (i + offset)/active_n for the
    (M, 1) systematic or (M, N) stratified offsets, clamped at 1 − 1e-7 in
    f32, so that the dead tail's slots repeat the last live ancestor."""
    i = torch.arange(n, device=offsets.device, dtype=torch.float32)
    return torch.clamp((i + offsets) / active_n, max=1.0 - 1e-7)


def _live(n: int, active_n: int, device, cols=None) -> torch.Tensor:
    """The live slots (1, N) of a row, or of this rank's particles of it."""
    return local_cols(torch.arange(n, device=device) < active_n, cols)[None, :]


def _log_f32(v: int) -> float:
    """log v rounded as an f32 log, as the JAX package takes it of its f32
    live count (a host float: no device transfer)."""
    return torch.log(torch.tensor(float(v), dtype=torch.float32)).item()


def _check_config(config: PFConfig, n: int, active_n=None) -> None:
    if config.algorithm not in ("bootstrap", "apf"):
        raise ValueError(
            f"unknown algorithm {config.algorithm!r}; one of ['bootstrap', 'apf']"
        )
    get_resampler(config.resampling)  # a ValueError naming the schemes
    if config.algorithm == "apf":  # the JAX package's errors
        if active_n is not None:
            raise ValueError(
                "algorithm='apf' is not defined for the elastic padded-N mode "
                "(use elastic_pad='grow' samplers or bootstrap)"
            )
        if config.proposal is not None:
            raise ValueError(
                "algorithm='apf' propagates from the transition (the lookahead "
                "replaces the proposal role); proposal= composes with the "
                "bootstrap algorithm only"
            )
        if config.ess_threshold < 1.0:
            raise ValueError(
                "algorithm='apf' resamples by construction every step (the "
                "first-stage lookahead IS the resample); ess_threshold < 1 "
                "composes with the bootstrap algorithm only"
            )
    proposal = config.proposal
    if proposal is not None and not (callable(getattr(proposal, "initial", None))
                                     and callable(getattr(proposal, "step", None))):
        raise TypeError(f"proposal must be a Proposal(initial, step), got {type(proposal)}")
    if active_n is not None and not 1 <= active_n <= n:
        raise ValueError(f"active_n must be in [1, {n}], got {active_n}")


def _rows(config: PFConfig, m_local: int):
    """This rank's rows of the bank whose m_local rows it holds (None
    without a mesh)."""
    mesh = config.mesh
    return None if mesh is None else theta_rows(mesh, m_local * theta_shards(mesh))


def _cols(config: PFConfig, n_local: int):
    """This rank's particles of the rows whose n_local particles it holds
    (None without particle sharding)."""
    return particle_cols(config.mesh, n_local * particle_shards(config.mesh))


def _log_normalize(log_w, cols, log_n: float | None = None, out=None):
    """``log_normalize`` along the particles; under particle sharding, of
    the whole rows gathered from the particle group, with this rank's window
    of the normalized log-weights (``log_n`` replaces log N, N the whole
    row's; ``out``, a buffer for the normalized log-weights)."""
    if cols is None:
        return log_normalize(log_w, log_n=log_n, out=out)
    log_mean, log_norm, ess = log_normalize(all_gather_cols(log_w, cols), log_n=log_n)
    return log_mean, _window(log_norm, cols, out), ess


def _window(x, cols, out=None):
    """This rank's particles of whole rows, contiguous: into ``out`` where
    given (a replayed step's buffer)."""
    mine = local_cols(x, cols)
    return mine.contiguous() if out is None else out.copy_(mine)


def _active(active_n):
    """The live count as a host int: a scalar of the step's glue (the grid's
    divisor, the live mask, log active_n), which a captured step holds."""
    return None if active_n is None else int(active_n)


def batched_pf_init(generator, models, n: int, m: int, y0,
                    config: PFConfig = PFConfig(), active_n=None) -> BatchedPFOut:
    """Init of all M filters at y0 (the bootstrap's, for the auxiliary
    filter too): N draws from each θ's initial distribution, weighted by the
    observation density; with ``config.proposal``, N draws from its initial
    distribution q0, weighted by the observation density times p(x)/q0(x).
    With ``active_n``, slots ≥ active_n get log-weight −inf and the
    evidence normalizes by active_n. With ``config.mesh``, ``models`` is
    the whole M-row bank and the outputs are this rank's rows (and, on a
    mesh that shards particles, its particles of each)."""
    active_n = _active(active_n)
    _check_config(config, n, active_n)
    rows, cols = theta_rows(config.mesh, m), particle_cols(config.mesh, n)
    proposal = config.proposal
    q0 = models.initial_distribution() if proposal is None else proposal.initial(models)
    x = q0.sample(generator, (n,))  # (N, M, dx)
    if tuple(x.shape[:2]) != (n, m):
        raise ValueError(f"models must carry {m} θ, drew shape {tuple(x.shape)}")
    x, local = _mine(x, rows, cols), local_model(models, rows)
    logw = local.observation_distribution(x).log_prob(y0)
    if proposal is not None:
        logw = (logw + local.initial_distribution().log_prob(x)
                - proposal.initial(local).log_prob(x))
    logw = logw.T.contiguous()
    particles = from_cloud(x.permute(1, 2, 0).contiguous())
    if active_n is None:
        log_mean, log_norm, ess = _log_normalize(logw, cols)
        return BatchedPFOut(particles, log_norm, log_mean, ess)
    logw = torch.where(_live(n, active_n, logw.device, cols), logw, -torch.inf)
    log_mean, log_norm, ess = _log_normalize(logw, cols, log_n=_log_f32(active_n))
    return BatchedPFOut(particles, log_norm, log_mean, ess)


def _draws(generator, models, m: int, n: int, device,
           config: PFConfig = PFConfig(), active_n=None, rows=None, cols=None):
    """The step's randomness, drawn in this order:

    - the resample's: u0 (M, 1) (systematic, ``residual_systematic``), a
      stratified grid u (M, N), uniforms (M, N) (multinomial, residual);
      with ``active_n``, the live-prefix grid's offsets, (M, 1) for the
      systematic schemes and (M, N) for the others, or the multinomial's
      uniforms; the generator itself for the metropolis resampler, which
      draws in the step;
    - the propagate's: a (1,) int64 Philox seed on a GPU or
      (n_normals, M, N) normals on the CPU; the generator itself for a
      guided proposal or a model without a kernel, which sample in the step.

    With ``rows`` (θ-sharding), m is the whole bank's and this rank keeps
    its rows of u and of the normals; with ``cols`` (particle sharding), n is
    the whole row's, u stays whole along it (the resample draws over the
    whole row and keeps its window) and the rank keeps its particles of the
    normals.
    """
    scheme = config.resampling
    if scheme == "metropolis" and active_n is None:
        u = generator
    elif scheme in _OFFSET_SCHEMES:
        u = torch.rand((m, 1), generator=generator, device=device)
    elif scheme == "stratified" and active_n is None:
        u = stratified_uniforms(generator, m, n, device)
    else:
        u = torch.rand((m, n), generator=generator, device=device)
    if config.proposal is not None or not _has_kernel(models):
        rest = generator
    elif device.type == "cpu":
        rest = torch.randn((models.update.n_normals, m, n), generator=generator)
    else:
        rest = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=device, dtype=torch.int64)
    if rows is not None:
        if isinstance(u, torch.Tensor):
            u = local_rows(u, rows).contiguous()
        if isinstance(rest, torch.Tensor) and rest.dtype != torch.int64:
            rest = local_rows(rest, rows, 1).contiguous()
    if cols is not None and isinstance(rest, torch.Tensor) and rest.dtype != torch.int64:
        rest = local_cols(rest, cols).contiguous()
    return u, rest


def _propagate_draws(seed_or_normals, rows=None, cols=None) -> dict:
    """The propagate kernel's draws: its Philox seed (an int64 tensor) with
    the global index of the rank's first row and, under particle sharding,
    of its first particle, or its injected normals (a float tensor, already
    the rank's rows and particles)."""
    if seed_or_normals.dtype != torch.int64:
        return {"normals": seed_or_normals}
    draws = {"seed": seed_or_normals, "row_offset": 0 if rows is None else rows.lo}
    if cols is not None:
        draws["particle_offset"] = cols.lo
    return draws


def _gather(cloud: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    """The (M, C, N) cloud gathered by (M, K) ancestors: (M, C, K)."""
    idx = anc.long()[:, None, :].expand(cloud.shape[0], cloud.shape[1], anc.shape[1])
    return torch.gather(cloud, 2, idx)


def _resample_gather(u, config: PFConfig, cloud, w, active_n=None, rows=None, cols=None):
    """The resample + gather of :func:`_pf_step_from_draws`: the (M, C, N)
    cloud gathered by each row's ancestors under the weights w, from the
    scheme's draws u (see :func:`_draws`; the metropolis resampler draws
    at the whole bank's shape under θ-sharding, ``rows``). With ``cols``
    (particle sharding), the cloud and w are the rank's rows whole along N,
    and only the rank's slots [lo, hi) of the output are resampled."""
    scheme, n = config.resampling, cloud.shape[2]
    if active_n is not None:
        if scheme == "multinomial":  # unsorted uniforms: the inverse cdf
            return _gather(cloud, local_cols(_inverse_cdf(u, w), cols))
        u_live = local_cols(_elastic_sorted_u(u, n, active_n), cols)
        return resample_gather_sorted(u_live.contiguous(), w, cloud)
    if scheme in _OFFSET_SCHEMES:
        if cols is None:
            return resample_gather(u, w, cloud)
        return resample_gather(u, w, cloud, slot_lo=cols.lo, n_out=cols.hi - cols.lo)
    if scheme == "stratified":
        return resample_gather_sorted(local_cols(u, cols).contiguous(), w, cloud)
    if scheme == "multinomial":
        anc = _inverse_cdf(u, w)
    elif scheme == "residual":
        anc = _residual_from_uniforms(u, w)
    elif rows is None:
        anc = metropolis(u, w)
    else:
        anc = local_rows(metropolis(u, tile_rows(w, rows)), rows)
    return _gather(cloud, local_cols(anc, cols))


def _guided_increment(models, q, xp, x_new, y) -> torch.Tensor:
    """The guided step's log-weight increment ≡ the JAX package's
    ``prop_one``: log g(y | x′) + log f(x′ | x) − log q(x′ | x), for the
    resampled states xp, the proposal q built at them and its draws x_new,
    both (N, M, dx); returns (N, M)."""
    return (models.observation_distribution(x_new).log_prob(y)
            + models.transition_distribution(xp).log_prob(x_new) - q.log_prob(x_new))


def _pf_step_from_draws(u, seed_or_normals, models, particles, log_w, y,
                        config: PFConfig = PFConfig(), params=None, active_n=None, out=None):
    """Deterministic core of :func:`batched_pf_step`, from its draws
    (:func:`_draws`): the resample + gather, the adaptive per-row selects
    when ``config.ess_threshold < 1``, then the propagate — the fused kernel
    with its Philox seed (an int64 tensor) or injected normals (a float
    tensor), or, from the generator passed in their place, a guided proposal
    or the transition of a model without a kernel. ``params`` are the
    model's step-invariant kernel parameters (:func:`kernel_params`), the
    rank's rows of them under θ-sharding, where ``models`` is the whole
    bank; ``active_n`` the elastic live count. Under particle sharding the
    particles and log-weights are the rank's slice of its rows, and u and
    the normals as :func:`_draws` keeps them. ``out``: on the routes the
    loops capture, the (M, dx, N) cloud and (M, N) log-weight buffers that
    the step writes (the kernel in place; under particle sharding the
    kernel writes the raw log-weights there, and the normalize the rank's
    window of the whole rows over them)."""
    rows = _rows(config, particles.shape[0])
    cols = _cols(config, particles.shape[1])
    n = particles.shape[1] if cols is None else cols.n
    cloud = as_cloud(particles)
    if cols is None:
        whole, w = cloud, torch.exp(log_w)
    else:  # the rows' whole clouds and log-weights, from the particle group
        whole, w = gather_row_cloud(cloud, log_w, cols)
        w = torch.exp(w)
    xp = _resample_gather(u, config, whole, w, active_n, rows, cols)
    if active_n is None:
        reset, n_live = torch.full_like(log_w, -math.log(n)), n
    else:
        live = _live(n, active_n, log_w.device, cols)
        reset = torch.where(live, -_log_f32(active_n), -torch.inf)
        n_live = active_n
    lw = reset
    if config.ess_threshold < 1.0:
        fire = 1.0 / torch.sum(w * w, dim=-1) < config.ess_threshold * n_live
        xp = torch.where(fire[:, None, None], xp, cloud)
        lw = torch.where(fire[:, None], reset, log_w)
    if config.proposal is None and active_n is None and _has_kernel(models):
        # the kernel's normalize: with a carry (normalized weights), lse of
        # carry + logw is the evidence increment; else the log-mean of the
        # unnormalized weights (the weights after resampling are all 1/N)
        carry = lw if config.ess_threshold < 1.0 else None
        local, draws = local_model(models, rows), _propagate_draws(seed_or_normals, rows, cols)
        if cols is None:
            new, log_norm, lse, ess = local.fused_propagate_reweight(
                y, xp, carry_logw=carry, params=params, out=out, **draws)
        else:  # the slice's raw log-weights, normalized as whole rows
            new, logw = local.fused_propagate_reweight(y, xp, params=params, normalize=False,
                                                       out=out, **draws)
            if carry is not None:
                logw = logw + carry
            log_norm, lse, ess = normalize_rows(all_gather_cols(logw, cols))
            log_norm = _window(log_norm, cols, None if out is None else out[1])
        log_mean = lse[:, 0] if carry is not None else lse[:, 0] - math.log(n)
        return BatchedPFOut(from_cloud(new), log_norm, log_mean, ess[:, 0])
    if config.proposal is None:
        new, incr = propagate_reweight(models, y, xp, seed_or_normals, params, rows, cols, out)
    else:
        # (N, M, dx): the models' distributions' layout, the whole bank's
        # draw kept at this rank's rows and particles
        states = _whole_bank(xp.permute(2, 0, 1), rows, cols)
        q = config.proposal.step(models, states)
        x_new = q.sample(seed_or_normals)
        incr = _mine(_guided_increment(models, q, states, x_new, y), rows, cols).T
        new = _mine(x_new, rows, cols).permute(1, 2, 0)
        new = new.contiguous() if out is None else out[0].copy_(new)
    if active_n is not None:
        incr = torch.where(live, incr, 0.0)  # the dead tail stays exactly −inf
    log_mean, log_norm, ess = _log_normalize(lw + incr, cols, log_n=0.0,
                                             out=None if out is None else out[1])
    return BatchedPFOut(from_cloud(new), log_norm, log_mean, ess)


def apf_lookahead(models, particles, y) -> torch.Tensor:
    """The auxiliary filter's lookahead log g(y | E[x′ | x]), (M, N), of the
    (M, N, dx) particles."""
    # the models' distributions take states with the θ axis just before the
    # state axis: the (N, M, dx) view of the particles
    mu = models.transition_distribution(particles.transpose(0, 1)).mean()
    return models.observation_distribution(mu).log_prob(y).T


def _apf_step_from_draws(u, seed_or_normals, models, particles, log_w, y,
                         config: PFConfig = PFConfig(), params=None, out=None):
    """Deterministic core of the auxiliary particle filter's step (the
    draws as in :func:`_pf_step_from_draws`): the lookahead, one resample
    launch on the (M, dx + 1, N) cloud with the lookahead plane, the model's
    step without the normalize on the split-off planes (a strided view, not
    copied), then the correction and the normalize. Under particle sharding
    the rows' whole clouds, with the lookahead plane, and their λ come in one
    gather, and λ is normalized over whole rows. ``out``: as
    :func:`_pf_step_from_draws`'s, written by the kernel and the normalize
    (the log-weight buffer holds the raw increment before it)."""
    dx = particles.shape[2]
    rows = _rows(config, particles.shape[0])
    cols = _cols(config, particles.shape[1])
    log_n = math.log(particles.shape[1] if cols is None else cols.n)
    log_g_mu = apf_lookahead(local_model(models, rows), particles, y)
    lam = log_w + log_g_mu
    aug = torch.cat([as_cloud(particles), log_g_mu[:, None, :]], dim=1)
    if cols is not None:
        aug, lam = gather_row_cloud(aug, lam, cols)
    lam_mean, lam_norm, _ = log_normalize(lam)
    gathered = _resample_gather(u, config, aug, torch.exp(lam_norm), rows=rows, cols=cols)
    new, incr = propagate_reweight(models, y, gathered[:, :dx], seed_or_normals, params, rows,
                                   cols, out=out)
    corr_mean, log_norm, ess = _log_normalize(incr - gathered[:, dx], cols,
                                              out=None if out is None else out[1])
    return BatchedPFOut(from_cloud(new), log_norm, lam_mean + log_n + corr_mean, ess)


def batched_pf_step(generator, models, particles, log_w, y,
                    config: PFConfig = PFConfig(), params=None,
                    active_n=None, out=None) -> BatchedPFOut:
    """One filter step for all M clouds: resample (every row, or the rows
    whose ESS fell below ``config.ess_threshold``·N), propagate, reweight by
    y and normalize — or, with ``config.algorithm == "apf"``, the auxiliary
    particle filter's step. ``params``: :func:`kernel_params`, computed
    once by callers that step the same models many times. ``active_n``: the
    elastic live count (slots past it are dead, at log-weight −inf). With
    ``config.mesh``, ``models`` and ``params`` are the whole M-row bank's
    and the particles and log-weights this rank's rows (and, on a mesh that
    shards particles, its slice of each). ``out``: on the routes
    :func:`captures` names, the (M, dx, N) cloud and (M, N) log-weight
    buffers that the step writes its particles and log-weights into (a
    captured step's, :mod:`.graphs`): the kernels write them in place, so
    no step copies the cloud."""
    m, n, _ = particles.shape
    active_n = _active(active_n)
    rows, cols = _rows(config, m), _cols(config, n)
    if rows is not None:
        m = rows.m
        params = None if params is None else local_rows(params, rows)
    if cols is not None:
        n = cols.n
    _check_config(config, n, active_n)
    u, rest = _draws(generator, models, m, n, particles.device, config, active_n, rows, cols)
    if config.algorithm == "apf":
        return _apf_step_from_draws(u, rest, models, particles, log_w, y, config, params, out)
    return _pf_step_from_draws(u, rest, models, particles, log_w, y, config, params, active_n,
                               out)


def captures(config: PFConfig, active_n, device) -> bool:
    """Whether the loops over an inner filter under ``config`` replay
    captured steps (:mod:`.graphs`):
    :func:`batched_log_likelihood_masked`, SMC²'s online step,
    ``filter_sequence`` and the forward bank; at the multinomial scheme also
    conditional SMC's and particle Gibbs's sweeps. On a CUDA device, outside
    :func:`.graphs.disable_graphs`: any model (a fused kernel's or the plain
    propagate route of a DSL model; its tensor fields become the route's
    buffers, its other leaves key it, :mod:`.graphs`), bootstrap, guided or
    auxiliary, every resampling scheme, and any ``active_n``: the live count
    is a host int that the captured step holds (the grid's divisor, the live
    mask, log active_n), so each live count keys a route of its own and the
    gate does not read it. On a mesh too (``config.mesh``, which keys the
    route with this rank's rows and particles): a step's collectives are
    cuts between its graphs, run eagerly at each replay (:mod:`.graphs`). A
    route whose step runs ``torch.linalg.eigh`` (an ``MvNormal`` with
    ``allow_singular``), which checks its errors on the host, runs its step
    bodies eagerly instead (:mod:`.graphs`)."""
    return graphs.enabled() and device.type == "cuda"


def batched_log_likelihood_masked(generator, models, n: int, m: int, y, mask,
                                  config: PFConfig = PFConfig(), active_n=None):
    """Log-likelihood of the observations y[t] with mask[t] > 0 for all M θ —
    the rejuvenation inner loop. Initializes at y[0] and steps only at the
    live times t ≥ 1, where the JAX package runs a jitted masked scan over
    all T: on the card, on the routes :func:`captures` names, by
    replaying captured CUDA graphs, ``graphs.STEPS_PER_GRAPH`` live times a
    launch and the rest one a launch (:mod:`.graphs`; eager inside
    :func:`.graphs.disable_graphs`), else by a Python loop over them; with
    ``active_n``, on the route of that live count. The init runs eagerly
    before the replays. ``mask`` is read on the host; the model's kernel
    parameters are packed once, outside the loop. In the span
    ``smc.filter``, its init in ``smc.filter_init`` (``utils/profiling.py``).

    Returns (particles (M, N, dx), log_w (M, N), log Z (M,)), this rank's
    rows of them (and its particles of each) under ``config.mesh``."""
    with named_scope("smc.filter"):
        with named_scope("smc.filter_init"):
            init = batched_pf_init(generator, models, n, m, y[0], config, active_n)
        particles, log_w, logz = init.particles, init.log_weights, init.log_mean
        params = kernel_params(models, config)
        live = torch.nonzero(torch.as_tensor(mask).cpu()[1:] > 0).flatten() + 1
        if live.numel() and captures(config, active_n, particles.device):
            return graphs.filter_live(generator, models, init, params, y, live, config,
                                      _active(active_n))
        for t in live.tolist():
            out = batched_pf_step(generator, models, particles, log_w, y[t], config,
                                  params, active_n)
            particles, log_w = out.particles, out.log_weights
            logz = logz + out.log_mean
        return particles, log_w, logz


def batched_log_likelihood(generator, models, n: int, m: int, y,
                           config: PFConfig = PFConfig(), active_n=None):
    """Full-sequence log-likelihood for all M θ (the density-tempered init
    and the exchange step's refilter). Returns (particles (M, N, dx),
    log_w (M, N), log Z (M,))."""
    return batched_log_likelihood_masked(generator, models, n, m, y,
                                         torch.ones(y.shape[0]), config, active_n)
