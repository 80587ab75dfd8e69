"""Sharded SMC² and IBIS on a (theta, particle) mesh (L4) — counterpart of
``sequential_monte_carlo_tpu/parallel/sharded.py``.

Where the JAX package compiles the sampler with sharding-annotated inputs
and lets GSPMD insert the collectives, the port runs the same program on
every rank (SPMD): the sampler, rebuilt with the mesh in its inner
``PFConfig``, holds this rank's rows of the clouds (and, where the mesh
shards particles, its particles of each row) and gathers what the θ-level
arithmetic needs (``samplers/smc2.py``, ``samplers/ibis.py``,
``ops/batched_filter.py``). On a θ-only mesh the numbers equal the unsharded
run's bit for bit; on a mesh that shards particles the per-row sums are
split over the particle group and round otherwise, so the run is close to
the unsharded one, and every rank of a particle group holds the same bits.
"""
from __future__ import annotations

from ..samplers.ibis import IBIS
from ..samplers.smc2 import SMC2
from .mesh import gather_state, ibis_state_shardings, make_mesh, shard_state, smc2_state_shardings


def _with_mesh(sampler, mesh):
    """The sampler rebuilt with ``mesh`` recorded in its inner config (a
    ValueError when M does not split over the θ-shards, or N over the
    particle shards)."""
    cfg = sampler.config
    if cfg.inner.mesh is mesh:
        return sampler
    cfg = cfg._replace(inner=cfg.inner._replace(mesh=mesh))
    return type(sampler)(sampler.model_fn, sampler.prior, cfg)


class ShardedSMC2:
    """SMC² over a (theta, particle) mesh of ranks.

    Usage (the same on every rank; the generator seeded alike)::

        mesh = make_mesh(n_theta_shards=2, n_particle_shards=2)
        sharded = ShardedSMC2(SMC2(model_fn, prior, cfg), mesh)
        state = sharded.init(gen, y)          # the clouds: this rank's part
        state, info = sharded.step(gen, state, y)
        whole = sharded.gather(state)         # every rank's rows
    """

    def __init__(self, sampler: SMC2, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.sampler = _with_mesh(sampler, self.mesh)
        self.shardings = smc2_state_shardings(self.mesh)

    @property
    def config(self):
        return self.sampler.config

    def init(self, generator, y):
        return self.sampler.init(generator, y)

    def step(self, generator, state, y):
        return self.sampler.step(generator, state, y)

    def run(self, generator, y, collect_fn=None):
        return self.sampler.run(generator, y, collect_fn=collect_fn)

    def run_segmented(self, generator, y, segment_size: int = 24, collect_fn=None,
                      state=None, max_steps=None):
        return self.sampler.run_segmented(generator, y, segment_size, collect_fn, state,
                                          max_steps)

    def reshard(self, state):
        """This rank's rows and particles of a whole state (e.g. a
        checkpoint's)."""
        return shard_state(state, self.shardings, self.mesh)

    def gather(self, state):
        """The whole state from every rank's part, on every rank (every rank
        calls it)."""
        return gather_state(state, self.shardings, self.mesh)


class ShardedIBIS:
    """IBIS with the θ axis sharded over the mesh: the Kalman bank by rows,
    the θ-level state whole on every rank. It has no particle axis: on a
    mesh that shards particles, the ranks of a particle group hold the same
    rows and compute the same numbers."""

    def __init__(self, ibis: IBIS, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ibis = _with_mesh(ibis, self.mesh)
        self.shardings = ibis_state_shardings(self.mesh)

    @property
    def config(self):
        return self.ibis.config

    def init(self, generator, y):
        return self.ibis.init(generator, y)

    def step(self, generator, state, y):
        return self.ibis.step(generator, state, y)

    def run(self, generator, y):
        return self.ibis.run(generator, y)

    def reshard(self, state):
        return shard_state(state, self.shardings, self.mesh)

    def gather(self, state):
        return gather_state(state, self.shardings, self.mesh)
