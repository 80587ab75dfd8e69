"""The port's θ-sharded SMC² and IBIS over torch.distributed (gloo on the
CPU) — the twin of tests/test_parallel.py. Each world runs in worker
processes (tests/torch_dist_worker.py: one thread each, a ``file://``
store in tmp_path); the one-process references run in a worker too, so
that both sides compute with the same thread count. A sharded run must
equal the unsharded one bit for bit: every draw is made at the whole bank's
shape and the gathers are exact."""
import json
import subprocess
import sys

import numpy as np
import pytest

from torch_dist_worker import ROUTES, run_world, start_world, wait_world

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process references and the 2- and 4-rank worlds, started
    together."""
    handles = {w: start_world("parallel", w, tmp_path_factory.mktemp(f"world{w}"))
               for w in WORLDS}
    handles[1] = start_world("plain", 1, tmp_path_factory.mktemp("plain"))
    return {w: wait_world(h)[0] for w, h in handles.items()}


@pytest.fixture(scope="module")
def plain(runs):
    return runs[1][0]


@pytest.fixture(scope="module")
def worlds(runs):
    return {w: runs[w] for w in WORLDS}


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


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_state_fields(worlds, world):
    """The clouds hold the rank's M/R rows; θ is whole; the specs say so."""
    res = worlds[world][0]
    assert res["local_particles_shape"].tolist() == [64 // world, 128, 1]
    assert res["local_theta_shape"].tolist() == [64, 3]
    assert json.loads(str(res["specs"])) == {
        "theta": "replicated", "particles": "rows", "log_w": "rows",
        "log_z": "replicated", "t": "replicated"}


def test_particle_sharded_mesh_raises(worlds):
    """A mesh with particle > 1 raises a ValueError naming the ROADMAP item,
    from the sampler and from the wrapper; it neither runs unsharded nor
    takes another route."""
    res = worlds[4][0]
    for key in ("particle_error", "particle_error_sharded"):
        assert "ROADMAP Queue 1 item 19" in str(res[key]), key


def test_density_tempered_refuses_a_mesh(worlds):
    """Density-tempered SMC runs unsharded: a sampler with a mesh raises."""
    assert "runs unsharded" in str(worlds[2][0]["dt_error"])


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
