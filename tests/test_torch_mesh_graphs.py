"""The meshes on the replays (``ops/graphs.py``): sharded SMC², IBIS and
density-tempered SMC run their loops on the mesh's routes. A θ-only mesh's
inner step needs no collective and replays as one process's does; a step
that holds a collective (a particle mesh's gathers, the online steps'
gather of the evidence over the θ group) is captured as segments with the
collective run eagerly between them (a cut).

On the CPU nothing is captured: in the gloo worlds of
tests/torch_dist_worker.py — the ones test_torch_parallel.py reads, run
once a session (``shared_runs``) — every rank runs each case twice, on its
routes with ``batched_filter.captures`` answering as on the card (the
buffers, the loads, the flag reads, the stores, the step bodies run eagerly
with their collectives between them, the launches grouped as the graphs
would launch them) and inside ``disable_graphs()``; the two are held bit for
bit on every rank, with the collectives each ran, and against the
one-process run. Each route's cuts a step equal the collectives of the
eager step it replays. The ``gpu`` cases at the end run the replays on the
card (two gloo ranks sharing cuda:0, one NCCL rank) and skip here; this
file imports no JAX, so the card runs them with

    python -m pytest --noconftest tests/test_torch_mesh_graphs.py -m gpu
"""
import json

import numpy as np
import pytest
import torch

from torch_dist_worker import (
    DT_ROUTES,
    PMESH_TWIN_ROUTES,
    TWIN_ENTRIES,
    TWIN_ROUTES,
    WORLD_SPECS,
    run_world,
    shared_runs,
)

CASES = TWIN_ROUTES + TWIN_ENTRIES + ("ibis",) + tuple(f"dt_{name}" for name in DT_ROUTES)
# each mesh of the worlds that run the twins, by (θ, particle) shape, and its cases
MESHES = {"2x1": CASES, "4x1": CASES, "1x2": CASES + PMESH_TWIN_ROUTES, "2x2": CASES}
MESH_CASES = [(mesh, case) for mesh, cases in MESHES.items() for case in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_runs(tmp_path_factory, WORLD_SPECS)


def _ranks(runs, mesh: str) -> list:
    n_theta, n_particle = map(int, mesh.split("x"))
    return runs[n_theta] if n_particle == 1 else runs[mesh]


def _config(case: str) -> str:
    """The SMC² configuration (a ROUTES name) whose eager steps a case's
    routes replay."""
    if case in TWIN_ENTRIES:
        return "lg_systematic"
    return case[len("dt_"):] if case.startswith("dt_") else case


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_routed_mesh_run_equals_its_eager_twin(runs, mesh, case):
    """On every rank the run on the mesh's routes equals its
    ``disable_graphs()`` twin bit for bit — θ, log ω, log Z, ESS, t, the live
    count, the gathered clouds, the infos and the collected series, DT's
    stages, IBIS's Kalman bank — and ran the same collectives (calls and
    bytes, ``collective_stats``)."""
    for r, res in enumerate(_ranks(runs, mesh)):
        keys = [k for k in res if k.startswith(f"routed_{case}/")]
        assert keys, case
        for k in keys:
            np.testing.assert_array_equal(res[k], res[k[len("routed_"):]],
                                          err_msg=f"rank {r}: {k}")
        routed, eager = (json.loads(str(res[f"stats_{p}{case}"])) for p in ("routed_", ""))
        assert routed == eager, f"rank {r}"
        assert routed["all_gather_calls"] > 0


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_routed_mesh_run_equals_one_process(runs, mesh, case):
    """The routed run equals the one-process run bit for bit on every rank:
    a θ-only mesh computes the unsharded numbers row for row, and on the CPU
    a particle mesh too (no sum over a row is split)."""
    plain = runs[1][0]
    keys = [k for k in plain if k.startswith(f"{case}/")]
    assert keys, case
    for r, res in enumerate(_ranks(runs, mesh)):
        for k in keys:
            np.testing.assert_array_equal(res[f"routed_{k}"], plain[k], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_route_cuts_equal_the_eager_steps_collectives(runs, mesh, case):
    """Each route's cuts a step equal the ``_collective`` calls of the
    eager step it replays: the masked filter's, one inner step's (none on a
    θ-only mesh; the particle group's gathers on a particle mesh); the
    online step's, the inner step's and the θ group's gather of the
    evidence; IBIS's, its gather of the log-likelihoods; the Kalman
    passes', none. A route launches one segment more than its cuts a graph;
    a step with a cut replays one step a launch."""
    n_particle = int(mesh.split("x")[1])
    for r, res in enumerate(_ranks(runs, mesh)):
        if case == "ibis":
            want = {"ibis": int(res["calls_ibis"]), "kalman": 0}
        else:
            inner, online = map(int, res[f"calls_{_config(case)}"])
            assert (inner == 0) == (n_particle == 1), (case, inner)
            assert online == inner + 1
            want = {"masked": inner, "online": online}
        routes = json.loads(str(res[f"routes_{case}"]))
        kinds = {kind for kind, *_ in routes}
        assert kinds == ({"masked"} if case.startswith("dt_") else set(want)), kinds
        for kind, cuts, replays, segments in routes:
            assert cuts == want[kind], (r, kind)
            assert replays > 0 and segments == replays * (cuts + 1), (r, kind)


@pytest.mark.parametrize("mesh", MESHES)
def test_two_meshes_take_two_routes(runs, mesh):
    """Two meshes of one shape in one process never share a route (a cut
    holds its mesh's group): one masked filter on each takes two routes,
    with the same numbers."""
    for res in _ranks(runs, mesh):
        assert int(res["two_meshes/routes"]) == 2
        np.testing.assert_array_equal(res["two_meshes/log_z0"], res["two_meshes/log_z1"])


# -- on the card ---------------------------------------------------------------

CARD_WORLDS = {"gloo:2x1": 2, "gloo:1x2": 2, "nccl:1x1": 1}


@pytest.fixture(scope="module")
def card_worlds(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the replays capture CUDA graphs")
    return {spec: run_world(f"gpu:{spec}", world, tmp_path_factory.mktemp(spec.replace(":", "_")),
                            timeout_s=900.0)[0]
            for spec, world in CARD_WORLDS.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CARD_WORLDS)
def test_replayed_mesh_run_equals_eager_on_the_card(card_worlds, spec):
    """Two gloo ranks sharing cuda:0 on (2, 1) and (1, 2), and one NCCL
    rank: LG SMC² through ``run`` with a collector, systematic and
    stratified at ESS < N/2, replayed from CUDA graphs (its online step as
    segments around the θ group's gather; on (1, 2) the inner steps around
    the particle group's), equals its ``disable_graphs()`` twin bit for bit
    on every rank, with the same collectives."""
    particle = spec.endswith("1x2")
    for r, res in enumerate(card_worlds[spec]):
        for case in ("systematic", "stratified"):
            for k in [k for k in res if k.startswith(f"routed_{case}/")]:
                np.testing.assert_array_equal(res[k], res[k[len("routed_"):]],
                                              err_msg=f"rank {r}: {k}")
            assert json.loads(str(res[f"stats_routed_{case}"])) == json.loads(
                str(res[f"stats_{case}"]))
            routes = json.loads(str(res[f"routes_{case}"]))
            assert {kind for kind, *_ in routes} == {"masked", "online"}
            for kind, cuts, replays, segments, graphed in routes:
                assert graphed and replays > 0 and segments == replays * (cuts + 1)
                assert (cuts > 0) == (kind == "online" or particle), (kind, cuts)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", CARD_WORLDS)
def test_direct_collective_raises_capture_error(card_worlds, spec):
    """A collector that calls ``torch.distributed.all_reduce`` itself, not
    through ``ops/sharding.py``, raises ``CaptureError`` at capture naming
    the collective and the collector (gloo would wait on the host inside
    the graph; NCCL would be captured out of ``collective_stats``)."""
    for res in card_worlds[spec]:
        error = str(res["direct/error"])
        assert "allreduce" in error and "direct" in error, error
