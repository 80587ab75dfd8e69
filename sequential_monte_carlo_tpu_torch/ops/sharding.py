"""θ-row sharding (L2): which rows of an M-row θ-bank a rank holds on a
(theta, particle) mesh, and the two collectives the sharded filter, SMC²
and IBIS use — an all_gather of rows and an all_reduce.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the dims
("theta", "particle") (``parallel.make_mesh``). Rank r of R along the θ
axis holds the contiguous rows [r·M/R, (r+1)·M/R) of every row-sharded
tensor; M must divide by R. A mesh with ``particle`` > 1 shards each θ's
cloud, which the port does not do yet (ROADMAP Queue 1 item 19): it raises.

Both collectives go through :func:`_collective`, which hands the tensor
to the process group as it is, on its own device: NCCL keeps it on the
card, and gloo takes CUDA tensors for ``all_gather`` and ``all_reduce``
and copies them through host memory itself. The compute around them stays
on the tensor's device. Each call is counted in ``collective_stats``:
calls, bytes received and host seconds per collective (for NCCL the host
seconds are the enqueue, for gloo the whole round trip).
"""
from __future__ import annotations

import collections
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..models.base import model_rows

PARTICLE_SHARDING_ITEM = "ROADMAP Queue 1 item 19 (particle-axis sharding)"

collective_stats = collections.Counter()


class ThetaRows(NamedTuple):
    """This rank's rows [lo, hi) of an m-row θ-bank split over ``shards``
    ranks of the θ axis's process ``group``."""

    lo: int
    hi: int
    m: int
    shards: int
    group: object


def theta_shards(mesh) -> int:
    """R, the number of θ-shards of ``mesh``; ValueError for a mesh that
    shards the particle axis."""
    if mesh.size(1) > 1:
        raise ValueError(f"a mesh with particle = {mesh.size(1)} > 1 shards each θ's cloud, "
                         f"which the port does not do yet: {PARTICLE_SHARDING_ITEM}")
    return mesh.size(0)


def theta_rows(mesh, m: int) -> ThetaRows | None:
    """This rank's rows of an m-row bank on ``mesh``; None without a mesh."""
    if mesh is None:
        return None
    shards = theta_shards(mesh)
    if m % shards:
        raise ValueError(f"M = {m} θ-particles do not split over {shards} θ-shards")
    k, r = m // shards, mesh.get_local_rank(0)
    return ThetaRows(r * k, (r + 1) * k, m, shards, mesh.get_group(0))


def local_rows(x: torch.Tensor, rows: ThetaRows | None, dim: int = 0) -> torch.Tensor:
    """The rank's rows of a whole tensor along ``dim`` (a view); ``x``
    itself without sharding."""
    return x if rows is None else x.narrow(dim, rows.lo, rows.hi - rows.lo)


def tile_rows(x: torch.Tensor, rows: ThetaRows, dim: int = 0) -> torch.Tensor:
    """The rank's rows tiled to a whole bank along ``dim``: rows [lo, hi)
    of the result are ``x`` (so are every other shard's rows). A draw
    through a distribution at the whole bank's shape, kept at [lo, hi),
    equals the unsharded draw's rows."""
    reps = [1] * x.dim()
    reps[dim] = rows.shards
    return x.repeat(reps)


def local_model(models, rows: ThetaRows | None):
    """The rank's rows of a θ-cloud model; ``models`` itself without
    sharding."""
    return models if rows is None else model_rows(models, rows.lo, rows.hi)


def _collective(op, out: torch.Tensor, x: torch.Tensor, group, name: str) -> torch.Tensor:
    """Run ``op(out, x, group)`` and count it in ``collective_stats``."""
    t0 = time.perf_counter()
    op(out, x, group)
    collective_stats[f"{name}_calls"] += 1
    collective_stats[f"{name}_bytes"] += out.numel() * out.element_size()
    collective_stats[f"{name}_s"] += time.perf_counter() - t0
    return out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (k, ...) concatenated along dim 0 in rank order,
    (R·k, ...). Exact: the gathered bits are the ranks' bits."""
    x = x.contiguous()
    out = torch.empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return _collective(lambda o, i, g: dist.all_gather(list(o.chunk(dist.get_world_size(g))),
                                                       i, group=g),
                       out, x, group, "all_gather")


def all_gather_rows(x: torch.Tensor, rows: ThetaRows | None) -> torch.Tensor:
    """The whole bank (M, ...) from every rank's rows (M/R, ...); ``x``
    itself without sharding."""
    return x if rows is None else all_gather(x, rows.group)


def all_reduce(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """``x`` reduced over the ranks of ``group`` ("sum" or "max"), as a new
    tensor (``torch.distributed.all_reduce`` runs in place)."""
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = x.clone().contiguous()
    return _collective(lambda o, _x, g: dist.all_reduce(o, op=reduce_op, group=g),
                       out, out, group, "all_reduce")
