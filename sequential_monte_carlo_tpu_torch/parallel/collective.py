"""Particle-axis building blocks (L4) — counterpart of
``sequential_monte_carlo_tpu/parallel/collective.py``, with a process group
in place of JAX's ``axis_name``: each rank holds ``n_local`` of a θ's
N = n_local · R particles.

  * ``all_reduce`` MAX/SUM — the log-sum-exp normalize and the ESS across
    the shards (``ops.weights.normalize_sharded``);
  * ``all_gather``         — the global cdf for the resample (O(N) scalars)
    and the ancestors' particles from any shard.

Each function is a deterministic core from its draws and a wrapper that
draws them from a ``torch.Generator`` that every rank holds alike (so that
a test can feed the JAX package's draws to the core). The batched filter
(``ops/batched_filter.py``) shards the particle axis inside SMC²'s filter
with the same semantics, batched over the θ-rows: the ancestors of a row
from its whole cloud, gathered in the particle group, and the normalize's
sums combined over it (``ops/weights.py``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..ops.sharding import all_gather, all_reduce
from ..ops.weights import normalize_sharded

__all__ = [
    "distributed_pf_step",
    "distributed_systematic_resample",
    "gather_global",
    "normalize_sharded",
]


def _systematic_from_u0(u0, w_local: torch.Tensor, group) -> torch.Tensor:
    """The core of :func:`distributed_systematic_resample` from its offset
    u0 (a scalar in [0, 1)), ≡ the JAX function: the global cdf from one
    all_gather of the weights, the rank's slice of the grid
    u_i = (i0 + i + u0)/N, i0 = rank · n_local, and the ancestors by
    searchsorted-left, clipped."""
    n_local = w_local.shape[-1]
    n_total = n_local * dist.get_world_size(group)
    cdf = torch.cumsum(all_gather(w_local, group), dim=0)
    cdf = cdf / cdf[-1]
    i0 = dist.get_rank(group) * n_local
    u = (i0 + torch.arange(n_local, dtype=w_local.dtype, device=w_local.device) + u0) / n_total
    anc = torch.searchsorted(cdf, u)
    return torch.clamp(anc, 0, n_total - 1).to(torch.int32)


def distributed_systematic_resample(generator, w_local: torch.Tensor, group=None):
    """Systematic resampling of a particle axis sharded over ``group``.

    Each rank holds ``w_local`` (n_local,), its slice of the *globally*
    normalized weights. Returns this rank's slice of the GLOBAL ancestor
    indices (sorted, as the grid is); :func:`gather_global` fetches their
    particles. Every rank draws the same u0 from its copy of the generator,
    so all draw one grid."""
    u0 = torch.rand((), generator=generator, device=w_local.device, dtype=w_local.dtype)
    return _systematic_from_u0(u0, w_local, group)


def gather_global(x_local: torch.Tensor, ancestors_global: torch.Tensor, group=None):
    """Particles by GLOBAL ancestor index across the shards: one all_gather
    of the (n_local, ...) particles, then a local take along dim 0."""
    return all_gather(x_local, group)[ancestors_global.long()]


def _fold_in(generator, rank: int, device) -> torch.Generator:
    """A generator of the rank's own stream (JAX's ``fold_in``): one seed
    drawn alike on every rank from the shared generator, plus the rank."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=device).item())
    return torch.Generator(device=device).manual_seed(seed + rank)


def _pf_step_from_draws(u0, prop_generator, model, x_local, log_w_local, y, group):
    """The core of :func:`distributed_pf_step` from the resample's offset
    u0 and the rank's propagate generator."""
    n_total = x_local.shape[0] * dist.get_world_size(group)
    maxw = all_reduce(torch.amax(log_w_local), "max", group)
    w = torch.exp(log_w_local - maxw)
    w = w / all_reduce(torch.sum(w), "sum", group)
    xp = gather_global(x_local, _systematic_from_u0(u0, w, group), group)
    x_new = model.transition_distribution(xp).sample(prop_generator)
    incr = model.observation_distribution(x_new).log_prob(y)
    gmax = all_reduce(torch.amax(incr), "max", group)
    gsum = all_reduce(torch.sum(torch.exp(incr - gmax)), "sum", group)
    log_mean = gmax + torch.log(gsum) - math.log(n_total)
    log_norm = incr - (gmax + torch.log(gsum))
    ess = 1.0 / all_reduce(torch.sum(torch.exp(2.0 * log_norm)), "sum", group)
    return x_new, log_norm, log_mean, ess


def distributed_pf_step(generator, model, x_local, log_w_local, y, group=None):
    """One bootstrap filter step of one θ's model with its particle axis
    sharded over ``group`` (the shard-level twin of ``pf_step``, always
    resampling): normalize with all_reduce MAX/SUM, resample on the global
    systematic grid, fetch the ancestors across the shards, propagate and
    reweight locally, each rank from its own stream. Returns (x_local′
    (n_local, dx), log_w_local′ (n_local,), log_mean, ess); the last two are
    whole on every rank."""
    u0 = torch.rand((), generator=generator, device=x_local.device, dtype=x_local.dtype)
    prop = _fold_in(generator, dist.get_rank(group), x_local.device)
    return _pf_step_from_draws(u0, prop, model, x_local, log_w_local, y, group)
