"""Multi-process launcher (L4) — counterpart of
``sequential_monte_carlo_tpu/parallel/launch.py``: θ-particles sharded
across processes, one device per process.

Every process runs the same program. ``torch.distributed`` wires the
processes into one group, and the (theta, particle) mesh spans them
(``parallel/mesh.py``). θ-shards exchange O(M) numbers a step (the
evidence increments, a rejuvenation's log-likelihoods) and the clouds at a
θ-resample; particle shards a row's whole cloud and log-weights each inner
step.

Launch with torchrun (the environment gives every argument)::

    torchrun --nproc-per-node 2 program.py

    from sequential_monte_carlo_tpu_torch.parallel import (
        initialize_distributed, make_global_mesh, ShardedSMC2)

    device = initialize_distributed()     # cuda:{LOCAL_RANK}, NCCL
    mesh = make_global_mesh()             # θ across the ranks
    sharded = ShardedSMC2(SMC2(model_fn, prior, cfg), mesh)
    gen = torch.Generator(device).manual_seed(0)   # the same seed on every rank
    state, infos = sharded.run(gen, y)             # y whole on every rank

or pass the arguments (``coordinator_address="host:port"``,
``num_processes``, ``process_id``, or ``init_method="file:///path"``).
NCCL takes one rank per GPU: ranks that share a card (two on one H100)
need ``backend="gloo"``, passed explicitly.

The ranks must take the same host decisions (the θ-ESS test, the exchange
test, a run's stops): they read whole values that every rank computes
alike. A rank that branched alone would wait in its next collective, so the
process group gets a finite ``timeout_s``, after which that collective
raises.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import make_mesh

__all__ = [
    "initialize_distributed",
    "make_global_mesh",
    "process_info",
]


def _env_int(value, name: str, default=None):
    if value is not None:
        return int(value)
    if name in os.environ:
        return int(os.environ[name])
    if default is None:
        raise ValueError(f"pass it, or set {name} (torchrun sets it)")
    return default


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None,
                           backend: str | None = None,
                           timeout_s: float = 300.0,
                           init_method: str | None = None,
                           device: str | None = None) -> torch.device:
    """``torch.distributed.init_process_group`` with torchrun's environment
    as the fallbacks: ``MASTER_ADDR``/``MASTER_PORT`` (or
    ``coordinator_address`` "host:port", or ``init_method``, e.g. a
    ``file://`` store), ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``. Returns
    the rank's device: ``cuda:{i % device_count}`` with i the first of
    ``local_device_ids`` or ``LOCAL_RANK`` (the rank when unset), made the
    current device; ``device="cpu"`` asks for the CPU. There is no CPU
    fallback: without a CUDA device and without ``device="cpu"`` it raises.

    ``backend`` None means NCCL on CUDA and gloo on the CPU. NCCL refuses
    two ranks on one GPU; that error is raised as it is, with the remedy
    (``backend="gloo"``) named — the backend is never switched here.
    ``timeout_s`` bounds every collective's wait. Safe to call once per
    process; a second call returns the device without initializing again.
    """
    rank = _env_int(process_id, "RANK")
    world = _env_int(num_processes, "WORLD_SIZE")
    if device == "cpu":
        dev = torch.device("cpu")
    elif device is not None:
        raise ValueError(f"device must be None (CUDA) or 'cpu', got {device!r}")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    else:
        local = (local_device_ids[0] if local_device_ids
                 else _env_int(None, "LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if init_method is None:
        init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":  # NCCL connects at its first collective: make it now
        try:
            dist.all_reduce(torch.zeros(1, device=dev))
        except dist.DistBackendError as e:
            if "Duplicate GPU" in str(e):
                raise RuntimeError(
                    "NCCL refuses two ranks on one GPU (Duplicate GPU detected): "
                    "ranks that share a card need backend='gloo'") from e
            raise
    return dev


def make_global_mesh(n_particle_shards: int | None = None):
    """(theta, particle) mesh over all ranks: θ across the ranks, the
    particle axis in blocks of ``n_particle_shards`` consecutive ranks
    (default 1: whole clouds on each rank, the right choice up to the
    reference's N = 8192)."""
    n_particle_shards = n_particle_shards or 1
    world = dist.get_world_size()
    if world % n_particle_shards:
        raise ValueError(f"{world} ranks not divisible by particle shards {n_particle_shards}")
    return make_mesh(n_theta_shards=world // n_particle_shards,
                     n_particle_shards=n_particle_shards)


def process_info() -> dict:
    """Topology snapshot for logging (the JAX package's keys): one device
    per process."""
    world = dist.get_world_size()
    return {
        "process_index": dist.get_rank(),
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
        "backend": dist.get_backend(),
    }
