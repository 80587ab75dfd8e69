"""Process meshes for SMC (L4) — counterpart of
``sequential_monte_carlo_tpu/parallel/mesh.py``.

A (theta, particle) mesh over the world's ranks, one device per rank:

  * axis ``"theta"``    — θ-particles sharded across ranks: every rank holds
    contiguous rows of the clouds, and the θ-level state is whole on each;
    a step gathers O(M) numbers, a θ-resample the clouds;
  * axis ``"particle"`` — each θ's cloud sharded across ranks. The
    building blocks are ``parallel/collective.py``'s; the samplers do not
    shard this axis yet, and a mesh with ``particle`` > 1 in their config
    raises (ROADMAP Queue 1 item 19).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("theta", "particle")``; ``mesh.get_group("theta")`` is the
θ axis's process group. Where JAX annotates a global array with a sharding,
the port's state holds the rank's rows: the specs below say per field
whether it is split by rows (``"rows"``) or whole on every rank
(``"replicated"``); :func:`shard_state` slices a whole state to this rank's
rows and :func:`gather_state` gathers it whole again.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..ops.batched_filter import as_cloud, from_cloud
from ..ops.sharding import all_gather_rows, local_rows, theta_rows, theta_shards

THETA_AXIS = "theta"
PARTICLE_AXIS = "particle"
ROWS, REPLICATED = "rows", "replicated"


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


def _specs(state_type, rows_fields: tuple, mesh):
    theta_shards(mesh)  # a ValueError for a mesh that shards particles
    return state_type(**{f.name: ROWS if f.name in rows_fields else REPLICATED
                         for f in dataclasses.fields(state_type)})


def smc2_state_shardings(mesh):
    """An SMC2State of specs: the clouds (``particles``, ``log_w``) by rows,
    every other field whole."""
    from ..samplers.base import SMC2State

    return _specs(SMC2State, ("particles", "log_w"), mesh)


def ibis_state_shardings(mesh):
    """An IBISState of specs: the Kalman bank (``mean``, ``cov``) by rows,
    every other field whole."""
    from ..samplers.base import IBISState

    return _specs(IBISState, ("mean", "cov"), mesh)


def _row_fields(specs) -> list:
    return [f.name for f in dataclasses.fields(specs) if getattr(specs, f.name) == ROWS]


def shard_state(state, specs, mesh):
    """This rank's rows of a whole state (a checkpoint, or an unsharded
    run's state): the fields whose spec is ``"rows"`` sliced to the rank's
    rows, as views; the others as they are."""
    rows = theta_rows(mesh, state.n_theta)
    return dataclasses.replace(state, **{name: local_rows(getattr(state, name), rows)
                                         for name in _row_fields(specs)})


def gather_state(state, specs, mesh):
    """The whole state from every rank's rows (collective: every rank of the
    mesh calls it): the fields whose spec is ``"rows"`` gathered."""
    rows = theta_rows(mesh, state.n_theta)

    def gather(name, x):  # the particles' planar storage is kept
        if name == "particles":
            return from_cloud(all_gather_rows(as_cloud(x), rows))
        return all_gather_rows(x, rows)

    return dataclasses.replace(state, **{name: gather(name, getattr(state, name))
                                         for name in _row_fields(specs)})
