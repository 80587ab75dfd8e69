"""Samplers sharded over θ and particles with ``torch.distributed`` (L4) —
counterpart of ``sequential_monte_carlo_tpu/parallel``: the launcher, the
(theta, particle) mesh, the sharded SMC² and IBIS, and the particle-axis
building blocks."""
from .collective import (
    distributed_pf_step,
    distributed_systematic_resample,
    gather_global,
)
from .launch import initialize_distributed, make_global_mesh, process_info
from .mesh import (
    PARTICLE_AXIS,
    THETA_AXIS,
    gather_state,
    ibis_state_shardings,
    make_mesh,
    shard_state,
    smc2_state_shardings,
)
from .sharded import ShardedIBIS, ShardedSMC2

__all__ = [
    "initialize_distributed",
    "make_global_mesh",
    "process_info",
    "THETA_AXIS",
    "PARTICLE_AXIS",
    "make_mesh",
    "shard_state",
    "smc2_state_shardings",
    "ibis_state_shardings",
    "ShardedSMC2",
    "ShardedIBIS",
    "distributed_systematic_resample",
    "distributed_pf_step",
    "gather_global",
]
