"""Process meshes for SMC (L4) — counterpart of
``sequential_monte_carlo_tpu/parallel/mesh.py``.

A (theta, particle) mesh over the world's ranks, one device per rank:

  * axis ``"theta"``    — θ-particles sharded across ranks: every rank holds
    contiguous rows of the clouds, and the θ-level state is whole on each;
    a step gathers O(M) numbers, a θ-resample the clouds;
  * axis ``"particle"`` — each θ's cloud sharded across ranks: rank
    (a, b) holds particles [b·N/Rp, (b+1)·N/Rp) of its rows; each inner
    filter step gathers a row's whole cloud and log-weights inside the
    particle group for the resample, and its raw log-weights for the
    normalize (O(N) a row and step, ``ops/batched_filter.py``). IBIS, which
    has no particles, holds the same rows on every rank of a particle group.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("theta", "particle")``; ``mesh.get_group("theta")`` is the
θ axis's process group. Where JAX annotates a global array with a sharding,
the port's state holds the rank's part: the specs below say per field
whether it is split by rows (``"rows"``), by rows and particles
(``"rows×particles"``, JAX's ``P(THETA, PARTICLE, None)``) or whole on
every rank (``"replicated"``); :func:`shard_state` slices a whole state to
this rank's part and :func:`gather_state` gathers it whole again.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..ops.batched_filter import as_cloud, from_cloud
from ..ops.sharding import (
    all_gather_cols,
    all_gather_rows,
    local_cols,
    local_rows,
    particle_cols,
    particle_shards,
    theta_rows,
)

THETA_AXIS = "theta"
PARTICLE_AXIS = "particle"
ROWS, ROWS_PARTICLES, REPLICATED = "rows", "rows×particles", "replicated"


def make_mesh(n_theta_shards: int | None = None, n_particle_shards: int = 1):
    """A (theta, particle) mesh over the world's ranks (the process group
    must be initialized: ``parallel.initialize_distributed``). ValueError
    unless n_theta_shards × n_particle_shards is the world size. The mesh's
    device type is "cuda" under NCCL and "cpu" under gloo: it only names
    the groups' device here (the port places no tensor through it), and
    gloo serves two ranks that share one card."""
    world = dist.get_world_size()
    if n_theta_shards is None:
        n_theta_shards = world // n_particle_shards
    if n_theta_shards * n_particle_shards != world:
        raise ValueError(f"mesh {n_theta_shards}x{n_particle_shards} != {world} ranks")
    device_type = "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"
    return init_device_mesh(device_type, (n_theta_shards, n_particle_shards),
                            mesh_dim_names=(THETA_AXIS, PARTICLE_AXIS))


def _specs(state_type, sharded: dict):
    return state_type(**{f.name: sharded.get(f.name, REPLICATED)
                         for f in dataclasses.fields(state_type)})


def smc2_state_shardings(mesh):
    """An SMC2State of specs: the clouds (``particles``, ``log_w``) by rows
    and particles, every other field whole. (``mesh`` is taken for the JAX
    package's signature: the specs are the same on every mesh.)"""
    from ..samplers.base import SMC2State

    return _specs(SMC2State, {"particles": ROWS_PARTICLES, "log_w": ROWS_PARTICLES})


def ibis_state_shardings(mesh):
    """An IBISState of specs: the Kalman bank (``mean``, ``cov``) by rows,
    every other field whole (on every rank of a particle group alike)."""
    from ..samplers.base import IBISState

    return _specs(IBISState, {"mean": ROWS, "cov": ROWS})


def _sharded_fields(specs) -> dict:
    return {f.name: getattr(specs, f.name) for f in dataclasses.fields(specs)
            if getattr(specs, f.name) != REPLICATED}


def shard_state(state, specs, mesh):
    """This rank's part of a whole state (a checkpoint, or an unsharded
    run's state): the fields whose spec is ``"rows"`` sliced to the rank's
    rows, those whose spec is ``"rows×particles"`` to its rows and its
    particles of each (dim 1), as views; the others as they are."""
    rows = theta_rows(mesh, state.n_theta)

    def mine(spec, x):
        x = local_rows(x, rows)
        return local_cols(x, particle_cols(mesh, x.shape[1]), 1) if spec == ROWS_PARTICLES else x

    return dataclasses.replace(state, **{name: mine(spec, getattr(state, name))
                                         for name, spec in _sharded_fields(specs).items()})


def gather_state(state, specs, mesh):
    """The whole state from every rank's part (collective: every rank of the
    mesh calls it): the sharded fields gathered over the particle axis, then
    over the θ axis; the particles' planar storage is kept."""
    rows = theta_rows(mesh, state.n_theta)

    def gather(name, spec, x):
        planar = name == "particles"
        if planar:
            x = as_cloud(x)  # (M, dx, N)
        if spec == ROWS_PARTICLES:
            dim = 2 if planar else 1
            x = all_gather_cols(x, particle_cols(mesh, x.shape[dim] * particle_shards(mesh)), dim)
        x = all_gather_rows(x, rows)
        return from_cloud(x) if planar else x

    return dataclasses.replace(state, **{name: gather(name, spec, getattr(state, name))
                                         for name, spec in _sharded_fields(specs).items()})
