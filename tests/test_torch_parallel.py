"""The port's sharded SMC² and IBIS over torch.distributed (gloo on the
CPU) — the twin of tests/test_parallel.py. Each world runs in worker
processes (tests/torch_dist_worker.py: one thread each, a ``file://``
store in tmp_path); the one-process references run in a worker too, so
that both sides compute with the same thread count. A θ-sharded run must
equal the unsharded one bit for bit: every draw is made at the whole bank's
shape and the gathers are exact. Runs on (θ, particle) meshes that shard
particles — (1, 2), (2, 2) and (1, 4) — are held as the JAX package holds its
(4, 2) mesh (θ within rtol 1e-3 and atol 1e-4 of the one-process run, the
θ-ESS within 1, the live count equal), every rank alike bit for bit, and,
since no sum over a row is split (the filter normalizes whole rows gathered
from the particle group), equal to the one-process run bit for bit on the
CPU. Density-tempered SMC on every one of these meshes equals its unsharded
run bit for bit."""
import json
import subprocess
import sys

import numpy as np
import pytest

from torch_dist_worker import (
    DT_ROUTES,
    PMESHES,
    ROUTES,
    WORLD_SPECS,
    WORLDS,
    run_world,
    shared_runs,
)

ENTRIES = ("run", "segmented", "reshard")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world of WORLD_SPECS, started together once a test session
    (``torch_dist_worker.shared_runs``)."""
    return shared_runs(tmp_path_factory, WORLD_SPECS)


@pytest.fixture(scope="module")
def plain(runs):
    return runs[1][0]


@pytest.fixture(scope="module")
def worlds(runs):
    return {w: runs[w] for w in WORLDS}


@pytest.fixture(scope="module")
def pworlds(runs):
    return {shape: runs[shape] for shape in PMESHES}


def _equal_on_every_rank(plain, ranks, prefix):
    keys = [k for k in plain if k.startswith(prefix + "/")]
    assert keys, prefix
    for r, res in enumerate(ranks):
        for k in keys:
            np.testing.assert_array_equal(res[k], plain[k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_smc2_equals_unsharded(plain, worlds, world, route):
    """θ, log ω, log Z, ESS, t, active_n and the gathered clouds of the
    sharded run equal the one-process run's bit for bit, on every rank:
    LG and UC-SV systematic, stratified at ESS < N/2 with carry, the APF,
    a guided proposal, the metropolis resampler (these two draw through the
    whole bank's shape), the exchange in grow and full padding, and an
    AR(1) declared with ssm_model (the plain propagate route)."""
    _equal_on_every_rank(plain, worlds[world], route)


def test_routes_exercise_their_paths(plain):
    """The runs compared above take the paths they are named for: the
    θ-resample and rejuvenation fired (θ-ESS reset), and the exchange
    doubled N."""
    for route in ROUTES:
        assert np.isfinite(plain[f"{route}/ess"]), route
    for pad in ("grow", "full"):  # N doubled 64 → 128 → 256, the cap
        assert plain[f"exchange_{pad}/active_n"] == 256
        assert plain[f"exchange_{pad}/particles"].shape[1] == 256
    # the θ-weights were reset by a rejuvenation somewhere along the run
    assert not np.array_equal(plain["lg_systematic/log_omega"], plain["lg_systematic/log_z"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("entry", ["run", "segmented"])
def test_wrapper_run_and_run_segmented(plain, worlds, world, entry):
    """``run`` with a collect_fn, and ``run_segmented`` split after 15 steps
    and resumed, through ShardedSMC2: the final state, the infos and the
    collected series equal the unsharded run's."""
    _equal_on_every_rank(plain, worlds[world], entry)


@pytest.mark.parametrize("world", WORLDS)
def test_reshard_then_step(plain, worlds, world):
    """A whole (unsharded) state placed on the ranks' rows, then one step:
    t + 1, and the unsharded step's numbers (test_parallel.py:88-98)."""
    _equal_on_every_rank(plain, worlds[world], "reshard")
    assert int(plain["reshard/t"]) == 7


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ibis_equals_ibis(plain, worlds, world):
    _equal_on_every_rank(plain, worlds[world], "ibis")
    assert int(plain["ibis/rejuvenations"]) > 0


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_shapes(worlds, world):
    res = worlds[world][0]
    assert res["mesh_shape"].tolist() == [world, 1]
    assert str(res["mesh_error"]) == f"mesh {world + 1}x2 != {world} ranks"
    if world == 4:
        assert res["pmesh_shape"].tolist() == [2, 2]


SPECS = {"theta": "replicated", "particles": "rows×particles", "log_w": "rows×particles",
         "log_z": "replicated", "t": "replicated"}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_state_fields(worlds, world):
    """The clouds hold the rank's M/R rows; θ is whole; the specs say so
    (rows and particles, JAX's P(THETA, PARTICLE, None), on every mesh)."""
    res = worlds[world][0]
    assert res["local_particles_shape"].tolist() == [64 // world, 128, 1]
    assert res["local_theta_shape"].tolist() == [64, 3]
    assert json.loads(str(res["specs"])) == SPECS


@pytest.mark.parametrize("shape", PMESHES)
def test_particle_sharded_state_fields(pworlds, shape):
    """On an (Rθ, Rp) mesh each rank holds M/Rθ rows and N/Rp particles of
    each; the mesh is the one asked for; N that does not split over the
    particle shards raises a ValueError."""
    n_theta, n_particle = map(int, shape.split("x"))
    for rank, res in enumerate(pworlds[shape]):
        assert res["mesh_shape"].tolist() == [n_theta, n_particle]
        assert res["mesh_coords"].tolist() == [rank // n_particle, rank % n_particle]
        assert res["local_particles_shape"].tolist() == [64 // n_theta, 128 // n_particle, 1]
        assert res["local_log_w_shape"].tolist() == [64 // n_theta, 128 // n_particle]
        assert json.loads(str(res["specs"])) == SPECS
        assert "do not split over" in str(res["n_error"])


def _theta_close(plain, ranks, prefix):
    """JAX's holding of its (4, 2) mesh (tests/test_parallel.py:59-77,
    :265-285): θ within rtol 1e-3 and atol 1e-4, the θ-ESS within 1, the
    live count and t equal, on every rank."""
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{prefix}/theta"], plain[f"{prefix}/theta"],
                                   rtol=1e-3, atol=1e-4, err_msg=f"rank {r}")
        assert abs(float(res[f"{prefix}/ess"]) - float(plain[f"{prefix}/ess"])) < 1.0
        for key in ("active_n", "t"):
            if f"{prefix}/{key}" in plain:
                assert int(res[f"{prefix}/{key}"]) == int(plain[f"{prefix}/{key}"]), key


@pytest.mark.parametrize("shape", PMESHES)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_particle_sharded_smc2_within_jax_tolerance(plain, pworlds, shape, route):
    """Every inner route — LG and UC-SV systematic, stratified at ESS < N/2
    with carry, the APF, a guided proposal, the metropolis resampler, the
    exchange in grow and full padding, the DSL's plain propagate route —
    on a mesh that shards particles, against the one-process run."""
    _theta_close(plain, pworlds[shape], route)


@pytest.mark.parametrize("shape", PMESHES)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_particle_sharded_smc2_equals_unsharded_on_the_cpu(plain, pworlds, shape, route):
    """No sum over a row is split, and the plain kernels' windows and
    slices are the whole launch's: on the CPU the particle-sharded run
    equals the one-process run bit for bit, its gathered clouds too."""
    _equal_on_every_rank(plain, pworlds[shape], route)


@pytest.mark.parametrize("shape", PMESHES)
@pytest.mark.parametrize("prefix", sorted(ROUTES) + list(ENTRIES) + ["ibis", "dead"])
def test_particle_group_ranks_agree_bitwise(pworlds, shape, prefix):
    """Every rank of a particle group holds the same θ, log ω, log Z, ESS
    and MH decisions, and so, after the θ-level gathers, every rank the same
    state: the ranks of a group normalize one gathered row in one order.
    ("dead": a filter's own rows, the same across a particle group.)"""
    ranks = pworlds[shape]
    keys = [k for k in ranks[0] if k.startswith(prefix + "/") and k != "dead/log_w"]
    assert keys
    for r, res in enumerate(ranks):
        first = next(x for x in ranks if prefix != "dead"
                     or x["mesh_coords"][0] == res["mesh_coords"][0])
        for k in keys:
            np.testing.assert_array_equal(res[k], first[k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("shape", PMESHES)
@pytest.mark.parametrize("entry", ENTRIES)
def test_particle_sharded_entries(plain, pworlds, shape, entry):
    """``run`` with a collect_fn, ``run_segmented`` split after 15 steps and
    resumed, and an unsharded state placed with ``reshard`` then stepped
    (t + 1), through ShardedSMC2 on a mesh that shards particles: within
    JAX's tolerance of the one-process run, and bit for bit on the CPU."""
    _theta_close(plain, pworlds[shape], entry)
    _equal_on_every_rank(plain, pworlds[shape], entry)


@pytest.mark.parametrize("shape", PMESHES)
def test_particle_sharded_reshard_gather_roundtrip(pworlds, shape):
    """``gather(reshard(state))`` gives every rank the whole state back bit
    for bit (JAX's test_reshard_roundtrip, on (2, 4) there)."""
    n_theta, n_particle = map(int, shape.split("x"))
    for res in pworlds[shape]:
        assert bool(res["reshard/roundtrip"])
        assert res["reshard/local_particles_shape"].tolist() == [64 // n_theta,
                                                                 128 // n_particle, 1]


@pytest.mark.parametrize("shape", PMESHES)
def test_particle_mesh_ibis_equals_theta_mesh(plain, worlds, pworlds, shape):
    """IBIS has no particles: on a mesh that shards them its state is copied
    across the particle ranks, and the run equals the θ-only mesh's with as
    many θ-shards ((2, 2) against (2, 1)) and the one-process run."""
    n_theta = int(shape.split("x")[0])
    ref = worlds[n_theta][0] if n_theta > 1 else plain
    _equal_on_every_rank(ref, pworlds[shape], "ibis")
    _equal_on_every_rank(plain, pworlds[shape], "ibis")


@pytest.mark.parametrize("shape", PMESHES)
def test_dead_slice_normalizes_finite(plain, pworlds, shape):
    """The elastic init at 64 live of 256 slots: where a rank's slice is
    all dead (ranks 1–3 on (1, 4)) its log-weights stay −inf, and the rows'
    log-mean and ESS are finite and the one-process run's; the live slots'
    weights are the unsharded window's bit for bit."""
    n_theta, n_particle = map(int, shape.split("x"))
    m, k = 8 // n_theta, 256 // n_particle
    for res in pworlds[shape]:
        a, b = map(int, res["mesh_coords"])
        rows = slice(a * m, (a + 1) * m)
        np.testing.assert_array_equal(res["dead/log_w"],
                                      plain["dead/log_w"][rows, b * k:(b + 1) * k])
        assert not np.isnan(res["dead/log_w"]).any()
        if b * k >= 64:
            assert (res["dead/log_w"] == -np.inf).all()
        assert np.isfinite(res["dead/log_mean"]).all() and np.isfinite(res["dead/ess"]).all()
        np.testing.assert_array_equal(res["dead/log_mean"], plain["dead/log_mean"][rows])
        np.testing.assert_array_equal(res["dead/ess"], plain["dead/ess"][rows])


# every mesh a world above runs: θ-only (Rθ, 1) and the particle meshes
DT_MESHES = [f"{w}x1" for w in WORLDS] + list(PMESHES)


@pytest.mark.parametrize("mesh", DT_MESHES)
@pytest.mark.parametrize("route", DT_ROUTES)
def test_sharded_density_tempered_equals_unsharded(plain, worlds, pworlds, mesh, route):
    """``density_tempered(ShardedSMC2(sampler, mesh).sampler, ...)``, the
    JAX idiom, with a systematic inner filter and a stratified one at
    ESS < N/2: θ, log ω, log Z, ESS and every stage's (ξ, ess, acc_ratio)
    equal the unsharded run's bit for bit on every rank (the bisection reads
    the same gathered log Ẑ), and each rank's clouds are its rows and
    particles of the unsharded clouds."""
    n_theta, n_particle = map(int, mesh.split("x"))
    ranks = worlds[n_theta] if n_particle == 1 else pworlds[mesh]
    assert len(plain[f"dt_{route}/xi"]) > 1 and plain[f"dt_{route}/xi"][-1] == 1.0
    assert (plain[f"dt_{route}/acc_ratio"][:-1] > 0).all()  # the moves ran
    _equal_on_every_rank(plain, ranks, f"dt_{route}")
    m, k = 64 // n_theta, 128 // n_particle
    for r, res in enumerate(ranks):
        a, b = map(int, res[f"dtcloud_{route}/coords"])
        assert [a, b] == [r // n_particle, r % n_particle]
        for key in ("particles", "log_w"):
            whole = plain[f"dtcloud_{route}/{key}"]
            np.testing.assert_array_equal(res[f"dtcloud_{route}/{key}"],
                                          whole[a * m:(a + 1) * m, b * k:(b + 1) * k],
                                          err_msg=f"rank {r}: {key}")


def test_diverged_ranks_end_in_an_error(tmp_path):
    """Rank 1 leaves the lockstep; both ranks end in an error, rank 0 within
    the process group's 3 s timeout, not in a hang."""
    ranks, _ = run_world("diverge", 2, tmp_path, timeout_s=120)
    assert str(ranks[0]["error"]), "rank 0 went on without its peer"
    assert float(ranks[0]["wait_s"]) < 3.0 + 10.0
    assert str(ranks[1]["error"]), "rank 1 went on without its peer"


def test_parallel_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import sequential_monte_carlo_tpu_torch.parallel as p\n"
            "import sequential_monte_carlo_tpu_torch.parallel.collective\n"
            "import sequential_monte_carlo_tpu_torch.examples.sv_animation\n"
            "import sequential_monte_carlo_tpu_torch.examples.ucsv_animation\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules "
            "if sys.modules[k] is not None)\n"
            "print(len(p.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "14"


def test_parallel_all_matches_jax():
    import sequential_monte_carlo_tpu.parallel as jp
    import sequential_monte_carlo_tpu_torch.parallel as tp

    assert tp.__all__ == jp.__all__
