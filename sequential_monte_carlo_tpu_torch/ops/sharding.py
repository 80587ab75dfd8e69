"""θ-row and particle sharding (L2): which rows of an M-row θ-bank, and
which particles of each row's cloud, a rank holds on a (theta, particle)
mesh, and the collectives the sharded filter, SMC² and IBIS use — an
all_gather (of rows, of a row's particle slices) and an all_reduce.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the dims
("theta", "particle") (``parallel.make_mesh``). Rank (a, b) of an
(Rθ, Rp) mesh holds the contiguous rows [a·M/Rθ, (a+1)·M/Rθ) of every
row-sharded tensor (:class:`ThetaRows`, over the θ axis's group: the ranks
of its particle column) and, where ``particle`` > 1, the contiguous
particles [b·N/Rp, (b+1)·N/Rp) of each of those rows (:class:`ParticleCols`,
over the particle axis's group: the Rp ranks that share its rows). M must
divide by Rθ and N by Rp.

Both collectives go through :func:`_collective`, which hands the tensor
to the process group as it is, on its own device: NCCL keeps it on the
card, and gloo takes CUDA tensors for ``all_gather`` and ``all_reduce``
and copies them through host memory itself. The compute around them stays
on the tensor's device. Each call is counted in ``collective_stats``:
calls, bytes received and host seconds per collective (for NCCL the host
seconds are the enqueue, for gloo the whole round trip).

While a replayed route captures a step (``ops/graphs.py``), a collective
runs no op: :data:`capture_cut` takes it and ends the graph there, and the
replays run it through :func:`_collective` between the step's graphs, so a
replayed run counts what its eager twin counts.
"""
from __future__ import annotations

import collections
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..models.base import model_rows

collective_stats = collections.Counter()
# set by ops/graphs.py while it captures a step: called in place of a
# collective's op with its (op, out, x, group, name), it returns ``out``
capture_cut = None


class ThetaRows(NamedTuple):
    """This rank's rows [lo, hi) of an m-row θ-bank split over ``shards``
    ranks of the θ axis's process ``group``."""

    lo: int
    hi: int
    m: int
    shards: int
    group: object


class ParticleCols(NamedTuple):
    """This rank's particles [lo, hi) of each row's n-particle cloud, split
    over ``shards`` ranks of the particle axis's process ``group``."""

    lo: int
    hi: int
    n: int
    shards: int
    group: object


def theta_shards(mesh) -> int:
    """Rθ, the number of θ-shards of ``mesh``."""
    return mesh.size(0)


def particle_shards(mesh) -> int:
    """Rp, the number of particle shards of ``mesh`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(1)


def theta_rows(mesh, m: int) -> ThetaRows | None:
    """This rank's rows of an m-row bank on ``mesh``; None without a mesh."""
    if mesh is None:
        return None
    shards = theta_shards(mesh)
    if m % shards:
        raise ValueError(f"M = {m} θ-particles do not split over {shards} θ-shards")
    k, r = m // shards, mesh.get_local_rank(0)
    return ThetaRows(r * k, (r + 1) * k, m, shards, mesh.get_group(0))


def particle_cols(mesh, n: int) -> ParticleCols | None:
    """This rank's particles of each row's n-particle cloud on ``mesh``;
    None without a mesh or where the mesh does not shard particles."""
    shards = particle_shards(mesh)
    if shards == 1:
        return None
    if n % shards:
        raise ValueError(f"N = {n} particles do not split over {shards} particle shards")
    k, b = n // shards, mesh.get_local_rank(1)
    return ParticleCols(b * k, (b + 1) * k, n, shards, mesh.get_group(1))


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


def local_cols(x: torch.Tensor, cols: ParticleCols | None, dim: int = -1) -> torch.Tensor:
    """The rank's particles of a whole tensor along ``dim`` (a view); ``x``
    itself without particle sharding."""
    return x if cols is None else x.narrow(dim, cols.lo, cols.hi - cols.lo)


def tile_cols(x: torch.Tensor, cols: ParticleCols | None, dim: int) -> torch.Tensor:
    """The rank's particles tiled to whole rows along ``dim`` (as
    :func:`tile_rows` tiles rows): a draw at the whole shape, kept at
    [lo, hi), equals the unsharded draw's particles there. ``x`` itself
    without particle sharding."""
    if cols is None:
        return x
    reps = [1] * x.dim()
    reps[dim] = cols.shards
    return x.repeat(reps)


def local_model(models, rows: ThetaRows | None):
    """The rank's rows of a θ-cloud model; ``models`` itself without
    sharding."""
    return models if rows is None else model_rows(models, rows.lo, rows.hi)


def _collective(op, out: torch.Tensor, x: torch.Tensor, group, name: str) -> torch.Tensor:
    """Run ``op(out, x, group)`` and count it in ``collective_stats``; inside
    a capture, hand it to :data:`capture_cut` instead (it runs and counts at
    each replay)."""
    if capture_cut is not None:
        return capture_cut(op, out, x, group, name)
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


def all_gather_cols(x: torch.Tensor, cols: ParticleCols | None, dim: int = -1) -> torch.Tensor:
    """Whole rows (..., N, ...) from every rank's particle slices along
    ``dim``, in rank order; ``x`` itself without particle sharding."""
    if cols is None:
        return x
    return torch.cat(tuple(all_gather(x.unsqueeze(0), cols.group)), dim=dim)


def gather_row_cloud(cloud: torch.Tensor, log_w: torch.Tensor, cols: ParticleCols):
    """The whole rows of the (m, C, N/Rp) cloud and its (m, N/Rp) log-weights
    from the particle group's slices: one all_gather of the cloud with the
    log-weights packed as one more plane, unpacked into the contiguous
    (m, C, N) cloud and (m, N) log-weights."""
    m, c, k = cloud.shape
    parts = all_gather(torch.cat([cloud, log_w[:, None, :]], dim=1).unsqueeze(0), cols.group)
    whole = parts.permute(1, 2, 0, 3)  # (m, C + 1, Rp, k)
    return (whole[:, :c].reshape(m, c, cols.n).contiguous(),
            whole[:, c].reshape(m, cols.n).contiguous())


def all_reduce(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """``x`` reduced over the ranks of ``group`` ("sum" or "max"), as a new
    tensor (``torch.distributed.all_reduce`` runs in place)."""
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = x.clone().contiguous()
    return _collective(lambda o, _x, g: dist.all_reduce(o, op=reduce_op, group=g),
                       out, out, group, "all_reduce")
