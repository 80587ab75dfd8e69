"""Worker of the port's multi-rank CPU tests (test_torch_parallel.py,
test_torch_collective.py, test_torch_multihost.py): one rank of a gloo
world on the CPU, joined through a ``file://`` store, one thread.

    python tests/torch_dist_worker.py SUITE RANK WORLD STORE OUT_DIR

Runs SUITE's cases (every rank alike) and writes ``OUT_DIR/RANK.npz``; the
parent process compares them. Imports the port only, never JAX: the JAX
numbers a suite needs come in as ``OUT_DIR/inputs.npz``. Suite "plain"
runs the one-process references without a process group; suite
"particle:RθxRp" the sampler cases on an (Rθ, Rp) mesh that shards
particles.

Suites "parallel" and "particle" also run the mesh cases of
test_torch_mesh_graphs.py twice (:func:`twins`): inside
``disable_graphs()`` and on the replayed routes, with
``batched_filter.captures`` answering as on the card (on the CPU a route
runs its step bodies eagerly through its buffers, its collectives between
them as a replay runs them), each with the collectives it ran and the
routes' cuts a step. :func:`shared_runs` starts the worlds once per test
session for both test files.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import sequential_monte_carlo_tpu_torch as smc  # noqa: E402
from sequential_monte_carlo_tpu_torch import parallel  # noqa: E402
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec  # noqa: E402
from sequential_monte_carlo_tpu_torch.ops import batched_filter as _bf  # noqa: E402
from sequential_monte_carlo_tpu_torch.ops import graphs  # noqa: E402
from sequential_monte_carlo_tpu_torch.ops.sharding import collective_stats  # noqa: E402
from sequential_monte_carlo_tpu_torch.utils.struct import replace  # noqa: E402

LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
UCSV_PRIOR = [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0), ("uniform", 0.0, 2.0),
              ("uniform", 0.0, 2.0)]


def lg_data(t: int = 40):
    return smc.simulate(torch.Generator().manual_seed(1998),
                        smc.lg_model(torch.tensor([0.5, 0.9, 0.8])), t)[1]


def ucsv_data(t: int = 12):
    return smc.simulate(torch.Generator().manual_seed(1998),
                        smc.ucsv_model(torch.tensor([0.2, 3.0, 0.5, 0.5])), t)[1]


def ar1_dsl():
    """lg_model's AR(1) written with ``ssm_model``: the plain propagate route."""
    normal = smc.Normal
    return smc.ssm_model(
        "ar1_dsl", params=("a", "q", "r"),
        init=lambda p: dict(x=normal(0.0, 1.0)),
        transition=lambda p, prev: dict(x=normal(p["a"] * prev["x"], torch.sqrt(p["q"]))),
        observe=lambda p, s: normal(s["x"], torch.sqrt(p["r"])))


# a guided proposal: the LG transition widened 1.5-fold
WIDENED = smc.Proposal(
    initial=lambda m: m.initial_distribution(),
    step=lambda m, xp: smc.Product(smc.Normal(m.A[..., 0, :] * xp,
                                              1.5 * torch.sqrt(m.Q[..., 0, :]))))


def lg_cfg(**kw):
    base = dict(n_particles=128, n_theta=64, chain=2, ess_threshold=0.5)
    return smc.SMCConfig(**{**base, **kw})


# (model_fn, prior, data, config, exchange stepping) of every SMC² route
ROUTES = {
    "lg_systematic": lambda: (smc.lg_model, LG_PRIOR, lg_data(), lg_cfg()),
    "ucsv_systematic": lambda: (smc.ucsv_model, UCSV_PRIOR, ucsv_data(),
                                lg_cfg(n_particles=64, n_theta=32)),
    "lg_stratified_carry": lambda: (smc.lg_model, LG_PRIOR, lg_data(),
                                    lg_cfg(inner=smc.PFConfig("stratified", 0.5))),
    "lg_apf": lambda: (smc.lg_model, LG_PRIOR, lg_data(),
                       lg_cfg(inner=smc.PFConfig("systematic", 1.0, None, "apf"))),
    "lg_guided": lambda: (smc.lg_model, LG_PRIOR, lg_data(),
                          lg_cfg(inner=smc.PFConfig(proposal=WIDENED))),
    "lg_metropolis": lambda: (smc.lg_model, LG_PRIOR, lg_data(),
                              lg_cfg(inner=smc.PFConfig("metropolis"))),
    "exchange_grow": lambda: (smc.lg_model, LG_PRIOR, lg_data(),
                              lg_cfg(n_particles=64, acc_threshold=1.1, exchange_max_n=128,
                                     elastic_pad="grow")),
    "exchange_full": lambda: (smc.lg_model, LG_PRIOR, lg_data(),
                              lg_cfg(n_particles=64, acc_threshold=1.1, exchange_max_n=128,
                                     elastic_pad="full")),
    "ar1_dsl": lambda: (ar1_dsl(), LG_PRIOR, lg_data(), lg_cfg()),
}
EXCHANGE_STEPS = 20  # the JAX test's (test_parallel.py:198)


def _theta_fields(state) -> dict:
    return {"theta": state.theta, "log_omega": state.log_omega, "log_z": state.log_z,
            "ess": state.ess, "t": torch.tensor(state.t),
            "active_n": torch.tensor(state.active_n)}


def run_route(name: str, mesh=None) -> dict:
    """One SMC² route, sharded over ``mesh`` or (None) unsharded, from
    seed 0: step + maybe_exchange over the whole series (20 steps on the
    exchange routes). Returns the whole state's fields."""
    model_fn, prior_spec, y, cfg = ROUTES[name]()
    sampler = smc.SMC2(model_fn, prior_from_spec(prior_spec, device="cpu"), cfg)
    if mesh is not None:
        sampler = parallel.ShardedSMC2(sampler, mesh)
    gen = torch.Generator().manual_seed(0)
    state = sampler.init(gen, y)
    steps = EXCHANGE_STEPS if name.startswith("exchange") else y.shape[0] - 1
    inner = sampler.sampler if mesh is not None else sampler
    for _ in range(steps):
        state, info = sampler.step(gen, state, y)
        state = inner.maybe_exchange(gen, state, y, info)
    whole = sampler.gather(state) if mesh is not None else state
    out = _theta_fields(whole)
    out["particles"], out["log_w"] = whole.particles, whole.log_w
    return out


# the inner filters of the density-tempered runs (ROUTES' setup)
DT_ROUTES = ("lg_systematic", "lg_stratified_carry")


def run_dt(name: str, mesh=None) -> tuple[dict, dict]:
    """Density-tempered SMC from seed 0 on ROUTES[name]'s setup, sharded
    over ``mesh`` (the sampler of ``ShardedSMC2(sampler, mesh)``) or (None)
    unsharded. Returns the θ-level fields with every stage's (ξ, ess,
    acc_ratio), and this rank's clouds (the whole clouds unsharded) with
    its mesh coordinates."""
    model_fn, prior_spec, y, cfg = ROUTES[name]()
    sampler = smc.SMC2(model_fn, prior_from_spec(prior_spec, device="cpu"), cfg)
    if mesh is not None:
        sampler = parallel.ShardedSMC2(sampler, mesh).sampler
    state, trace = smc.density_tempered(sampler, torch.Generator().manual_seed(0), y)
    out = _theta_fields(state)
    out.update({k: torch.tensor([getattr(s, k) for s in trace], dtype=torch.float64)
                for k in ("xi", "ess", "acc_ratio")})
    coords = [0, 0] if mesh is None else [mesh.get_local_rank(0), mesh.get_local_rank(1)]
    return out, {"particles": state.particles, "log_w": state.log_w,
                 "coords": torch.tensor(coords)}


def run_entry(kind: str, mesh=None) -> dict:
    """``run`` with a collect_fn, and ``run_segmented`` split after 15
    steps and resumed, through the wrapper (or the plain sampler); kind
    "collected": that split ``run_segmented`` with the collect_fn, its
    series and the gathered clouds too."""
    model_fn, prior_spec, y, cfg = ROUTES["lg_systematic"]()
    sampler = smc.SMC2(model_fn, prior_from_spec(prior_spec, device="cpu"), cfg)
    if mesh is not None:
        sampler = parallel.ShardedSMC2(sampler, mesh)
    gen = torch.Generator().manual_seed(1)
    if kind == "run":
        state, (infos, series) = sampler.run(gen, y, collect_fn=smc.expected_parameters)
        return {**_theta_fields(state), "infos_ess": infos.ess, "series": series}
    collect = smc.expected_parameters if kind == "collected" else None
    state, infos = sampler.run_segmented(gen, y, segment_size=8, max_steps=15, collect_fn=collect)
    state, infos2 = sampler.run_segmented(gen, y, segment_size=8, state=state,
                                          collect_fn=collect)
    if collect is None:
        return {**_theta_fields(state), "infos_ess": torch.cat([infos.ess, infos2.ess])}
    (infos, series), (infos2, series2) = infos, infos2
    whole = sampler.gather(state) if mesh is not None else state
    return {**_theta_fields(state), "infos_ess": torch.cat([infos.ess, infos2.ess]),
            "series": torch.cat([series, series2]), "particles": whole.particles,
            "log_w": whole.log_w}


def reshard_step(mesh=None) -> dict:
    """An unsharded run's state after 5 steps, placed on this rank's rows
    (``reshard``), then one sharded step: t + 1, and the unsharded step's
    numbers. With a mesh, also whether ``gather`` of the placed state gives
    the whole state back bit for bit (``roundtrip``)."""
    model_fn, prior_spec, y, cfg = ROUTES["lg_systematic"]()
    base = smc.SMC2(model_fn, prior_from_spec(prior_spec, device="cpu"), cfg)
    gen = torch.Generator().manual_seed(2)
    state = base.init(gen, y)
    for _ in range(5):
        state, _ = base.step(gen, state, y)
    if mesh is None:
        stepped, _ = base.step(gen, state, y)
        return _theta_fields(stepped)
    sh = parallel.ShardedSMC2(base, mesh)
    placed = sh.reshard(state)
    if not torch.equal(placed.theta, state.theta):
        raise AssertionError("reshard changed θ")
    back = sh.gather(placed)
    roundtrip = all(torch.equal(getattr(back, k), getattr(state, k))
                    for k in ("particles", "log_w", "theta", "log_z"))
    stepped, _ = sh.step(gen, placed, y)
    return {**_theta_fields(stepped), "roundtrip": torch.tensor(roundtrip),
            "local_particles_shape": torch.tensor(placed.particles.shape)}


def run_ibis(mesh=None) -> dict:
    ibis = smc.IBIS(smc.lg_model, prior_from_spec(LG_PRIOR, device="cpu"),
                    smc.SMCConfig(n_theta=64, chain=2, ess_threshold=0.5))
    if mesh is not None:
        ibis = parallel.ShardedIBIS(ibis, mesh)
    state, infos = ibis.run(torch.Generator().manual_seed(3), lg_data())
    whole = ibis.gather(state) if mesh is not None else state
    return {"theta": whole.theta, "log_omega": whole.log_omega, "log_z": whole.log_z,
            "ess": whole.ess, "mean": whole.mean, "cov": whole.cov,
            "t": torch.tensor(whole.t), "rejuvenations": infos.rejuvenated.sum()}


def dead_slice_init(mesh=None) -> dict:
    """The elastic filter's init at N = 256 with 64 live slots (8 LG rows):
    on a mesh of 4 particle shards the live prefix is rank 0's whole slice
    and the other ranks' slices are dead. This rank's log-weights, and the
    rows' log-mean and ESS."""
    theta = torch.tensor([[0.5, 0.9, 0.8]]).repeat(8, 1) * torch.linspace(0.8, 1.2, 8)[:, None]
    out = smc.batched_pf_init(torch.Generator().manual_seed(4), smc.lg_model(theta), 256, 8,
                              lg_data()[0], smc.PFConfig(mesh=mesh), active_n=64)
    return {"log_w": out.log_weights, "log_mean": out.log_mean, "ess": out.ess}


def _flat(prefix: str, d: dict) -> dict:
    return {f"{prefix}/{k}": torch.as_tensor(v).numpy() for k, v in d.items()}


@contextlib.contextmanager
def _routed():
    """``batched_filter.captures`` answering as on the card (the ``routed``
    fixture of tests/test_torch_elastic_graphs.py): the loops take their
    routes, which on the CPU run their step bodies eagerly through the
    buffers."""
    gate = _bf.captures
    _bf.captures = lambda config, active_n, device: gate(config, active_n,
                                                         torch.device("cuda"))
    graphs.clear_graphs()
    try:
        yield
    finally:
        _bf.captures = gate


def _stats() -> str:
    """The collectives run since the last clear: calls and bytes by kind."""
    return json.dumps({k: v for k, v in sorted(collective_stats.items()) if not k.endswith("_s")})


def twins(out: dict, prefix: str, fn) -> None:
    """``fn()`` (a dict of tensors) on the routes, under
    ``routed_<prefix>``, and inside ``disable_graphs()``, under ``prefix``,
    each with the collectives it ran (``stats_[routed_]<prefix>``); and the
    routes the routed run left, (kind, cuts a step, replays, segment
    replays) each (``routes_<prefix>``)."""
    for routed in (True, False):
        collective_stats.clear()
        with _routed() if routed else smc.disable_graphs():
            res = fn()
        name = f"routed_{prefix}" if routed else prefix
        out.update(_flat(name, res))
        out[f"stats_{name}"] = np.asarray(_stats())
        if routed:
            out[f"routes_{prefix}"] = np.asarray(json.dumps(
                [(key[0], r.cuts, r.replays, r.segment_replays)
                 for key, r in graphs._cache.items()]))
            graphs.clear_graphs()


def step_calls(name: str, mesh) -> np.ndarray:
    """The collectives of one eager inner step (``batched_pf_step``) and
    of one eager online step without a rejuvenation (``SMC2.step``) of
    ROUTES[name]'s sampler on ``mesh``, from its init."""
    model_fn, prior_spec, y, cfg = ROUTES[name]()
    sampler = parallel.ShardedSMC2(smc.SMC2(model_fn, prior_from_spec(prior_spec, device="cpu"),
                                            cfg), mesh).sampler
    gen = torch.Generator().manual_seed(5)
    with smc.disable_graphs():
        state = sampler.init(gen, y)
        first = graphs._calls()
        _bf.batched_pf_step(gen, sampler.model_fn(state.theta), state.particles, state.log_w,
                            y[1], sampler.config.inner, active_n=sampler._active(state))
        inner = graphs._calls()
        sampler.step(gen, replace(state, ess=torch.full((), float(cfg.n_theta))), y)
    return np.asarray([inner - first, graphs._calls() - inner])


def ibis_step_calls(mesh) -> int:
    """The collectives of one eager IBIS step without a rejuvenation."""
    ibis = parallel.ShardedIBIS(smc.IBIS(smc.lg_model, prior_from_spec(LG_PRIOR, device="cpu"),
                                         smc.SMCConfig(n_theta=64, chain=2)), mesh).ibis
    y = lg_data()
    with smc.disable_graphs():
        state = ibis.init(torch.Generator().manual_seed(5), y)
        first = graphs._calls()
        ibis.step(None, replace(state, ess=torch.full((), 64.0)), y)
    return graphs._calls() - first


# the cases the mesh worlds run as twins (test_torch_mesh_graphs.py): SMC²
# through step (+ maybe_exchange) — systematic, the exchange in grow and in
# full padding —, run with a collector and run_segmented split with one;
# density-tempered SMC, systematic and stratified at ESS < N/2; IBIS; on
# (1, 2) also the APF and the DSL's plain propagate route
TWIN_ROUTES = ("lg_systematic", "exchange_grow", "exchange_full")
PMESH_TWIN_ROUTES = ("lg_apf", "ar1_dsl")
TWIN_ENTRIES = ("run", "collected")


def mesh_cases(out: dict, mesh, twin_routes=()) -> None:
    """The sampler cases on ``mesh`` (None: one process): every SMC²
    route, the entries, reshard + step, IBIS and density-tempered SMC;
    with ``twin_routes`` (a mesh) those routes, the entries of TWIN_ENTRIES,
    IBIS and density-tempered SMC as :func:`twins` (the eager twin under the
    plain key), the eager steps' collectives beside them (``calls_<route>``,
    ``calls_ibis``) and two meshes of the mesh's shape in one process
    (``two_meshes/…``)."""
    twin = (lambda prefix, fn: twins(out, prefix, fn)) if twin_routes else (
        lambda prefix, fn: out.update(_flat(prefix, fn())))
    for name in ROUTES:
        run = lambda name=name: run_route(name, mesh)  # noqa: E731
        twin(name, run) if name in twin_routes else out.update(_flat(name, run()))
    for kind in ("run", "segmented", "collected"):
        run = lambda kind=kind: run_entry(kind, mesh)  # noqa: E731
        twin(kind, run) if kind in TWIN_ENTRIES else out.update(_flat(kind, run()))
    out.update(_flat("reshard", reshard_step(mesh)))
    twin("ibis", lambda: run_ibis(mesh))
    for name in DT_ROUTES:
        clouds = {}

        def run(name=name):
            fields, cloud = run_dt(name, mesh)
            clouds.update(cloud)
            return fields
        twin(f"dt_{name}", run)  # the eager run's clouds last
        out.update(_flat(f"dtcloud_{name}", clouds))
    if not twin_routes:
        return
    for name in twin_routes + DT_ROUTES:
        out[f"calls_{name}"] = step_calls(name, mesh)
    out["calls_ibis"] = np.asarray(ibis_step_calls(mesh))
    # two meshes of the mesh's shape: one masked filter on each
    other = parallel.make_mesh(*mesh.shape)
    model_fn, prior_spec, y, cfg = ROUTES["lg_systematic"]()
    theta = prior_from_spec(prior_spec, device="cpu").sample(torch.Generator().manual_seed(6),
                                                             (cfg.n_theta,))
    with _routed():
        for i, m in enumerate((mesh, other)):
            res = smc.batched_log_likelihood(torch.Generator().manual_seed(7), model_fn(theta),
                                             cfg.n_particles, cfg.n_theta, y,
                                             cfg.inner._replace(mesh=m))
            out[f"two_meshes/log_z{i}"] = res[2].numpy()
        out["two_meshes/routes"] = np.asarray(len(graphs._cache))
    graphs.clear_graphs()


def suite_plain(out: dict) -> None:
    mesh_cases(out, None)
    out.update(_flat("multihost", multihost_run()))
    out.update(_flat("dead", dead_slice_init()))


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def suite_parallel(out: dict, world: int) -> None:
    mesh = parallel.make_mesh(n_theta_shards=world)
    out["mesh_shape"] = np.asarray(mesh.shape)
    out["mesh_error"] = np.asarray(_raises(lambda: parallel.make_mesh(world + 1, 2)))
    specs = parallel.smc2_state_shardings(mesh)
    out["specs"] = np.asarray(json.dumps({k: getattr(specs, k) for k in
                                          ("theta", "particles", "log_w", "log_z", "t")}))
    mesh_cases(out, mesh, TWIN_ROUTES)
    # the rank's rows of a sharded state
    model_fn, prior_spec, y, cfg = ROUTES["lg_systematic"]()
    sh = parallel.ShardedSMC2(smc.SMC2(model_fn, prior_from_spec(prior_spec, device="cpu"),
                                       cfg), mesh)
    st = sh.init(torch.Generator().manual_seed(0), y)
    out["local_particles_shape"] = np.asarray(st.particles.shape)
    out["local_theta_shape"] = np.asarray(st.theta.shape)
    if world == 4:  # a mesh that shards particles
        out["pmesh_shape"] = np.asarray(parallel.make_mesh(2, 2).shape)


def suite_particle(out: dict, world: int, shape: str) -> None:
    """The sampler cases on an (Rθ, Rp) mesh that shards particles: every
    SMC² route, ``run``/``run_segmented``, reshard + step, IBIS,
    density-tempered SMC, and the rank's part of a sharded state."""
    n_theta, n_particle = map(int, shape.split("x"))
    mesh = parallel.make_mesh(n_theta, n_particle)
    out["mesh_shape"] = np.asarray(mesh.shape)
    out["mesh_coords"] = np.asarray([mesh.get_local_rank(0), mesh.get_local_rank(1)])
    twin_routes = (TWIN_ROUTES + (PMESH_TWIN_ROUTES if shape == "1x2" else ())
                   if shape in MESH_GRAPH_PMESHES else ())
    mesh_cases(out, mesh, twin_routes)
    out.update(_flat("dead", dead_slice_init(mesh)))
    model_fn, prior_spec, y, cfg = ROUTES["lg_systematic"]()
    sh = parallel.ShardedSMC2(smc.SMC2(model_fn, prior_from_spec(prior_spec, device="cpu"),
                                       cfg), mesh)
    specs = sh.shardings
    out["specs"] = np.asarray(json.dumps({k: getattr(specs, k) for k in
                                          ("theta", "particles", "log_w", "log_z", "t")}))
    st = sh.init(torch.Generator().manual_seed(0), y)
    out["local_particles_shape"] = np.asarray(st.particles.shape)
    out["local_log_w_shape"] = np.asarray(st.log_w.shape)
    out["n_error"] = np.asarray(_raises(lambda: parallel.ShardedSMC2(smc.SMC2(
        model_fn, prior_from_spec(prior_spec, device="cpu"),
        cfg._replace(n_particles=129)), mesh)))


# the particle meshes whose worlds run the mesh cases
MESH_GRAPH_PMESHES = ("1x2", "2x2")


def multihost_run(mesh=None) -> dict:
    """The JAX multi-host worker's run (tests/multihost_worker.py): LG,
    M=32, N=64, T=24, chain=2; t, the θ-ESS and θ̂."""
    y = lg_data(24)
    sampler = smc.SMC2(smc.lg_model, prior_from_spec(LG_PRIOR, device="cpu"),
                       smc.SMCConfig(n_particles=64, n_theta=32, chain=2, ess_threshold=0.5))
    if mesh is not None:
        sampler = parallel.ShardedSMC2(sampler, mesh)
    gen = torch.Generator().manual_seed(0)
    state = sampler.init(gen, y)
    for _ in range(1, y.shape[0]):
        state, _ = sampler.step(gen, state, y)
    return {"t": torch.tensor(state.t), "ess": state.ess,
            "theta_hat": smc.expected_parameters(state)}


def suite_multihost(out: dict, world: int) -> None:
    """Through the launcher: ``make_global_mesh`` over both processes and
    ``process_info``; prints the JAX worker's JSON line."""
    info = parallel.process_info()
    if info["process_count"] != world or info["global_device_count"] != world:
        raise AssertionError(f"process_info {info}")
    mesh = parallel.make_global_mesh()
    res = multihost_run(mesh)
    out.update(_flat("multihost", res))
    print(json.dumps({"process": info["process_index"], "ess": float(res["ess"]),
                      "t": int(res["t"]), "theta_hat": res["theta_hat"].tolist(),
                      "backend": info["backend"]}), flush=True)


def suite_collective(out: dict, world: int) -> None:
    """The particle-axis blocks on the parent's (JAX's) inputs: this rank's
    slice of each."""
    from sequential_monte_carlo_tpu_torch.parallel.collective import (
        _systematic_from_u0, distributed_pf_step, gather_global)

    inp = np.load(Path(sys.argv[5]) / "inputs.npz")
    rank = torch.distributed.get_rank()

    def mine(a, axis=0):
        k = a.shape[axis] // world
        return torch.from_numpy(np.take(a, np.arange(rank * k, (rank + 1) * k), axis=axis))

    out["ancestors"] = _systematic_from_u0(torch.tensor(inp["u0"]), mine(inp["w"]), None).numpy()
    n = 256
    x = torch.arange(n, dtype=torch.float32)[:, None]
    out["gathered"] = gather_global(mine(x.numpy()), mine(np.flip(np.arange(n)).copy()),
                                    None).numpy()
    norm = smc.normalize_sharded(mine(inp["log_w"], 1))
    out["log_mean"], out["weights"], out["ess"] = (v.numpy() for v in norm)
    # the sharded bootstrap filter on JAX's LG series, N = 1024
    y = torch.from_numpy(inp["y"])
    model = smc.lg_model(torch.tensor([0.5, 0.9, 0.8]))
    gen = torch.Generator().manual_seed(11)
    x0 = mine(model.initial_distribution().sample(gen, (1024,)).numpy())
    lw0 = model.observation_distribution(x0).log_prob(y[0])
    norm0 = smc.normalize_sharded(lw0)
    xs, lw, logz, esss = x0, torch.log(norm0.weights), norm0.log_mean, []
    for t in range(1, y.shape[0]):
        xs, lw, lm, ess = distributed_pf_step(gen, model, xs, lw, y[t])
        logz, esss = logz + lm, esss + [ess]
    out["pf_log_z"], out["pf_ess"] = logz.numpy(), torch.stack(esss).numpy()


def suite_gpu(out: dict, world: int, arg: str) -> None:
    """On the card (suite "gpu:BACKEND:RθxRp", every rank on a card): LG
    SMC² through ``run`` with a collector, systematic and stratified at
    ESS < N/2, replayed and inside ``disable_graphs()`` (``routed_<case>/…``
    and ``<case>/…``, the collectives each ran, the routes' cuts, replays
    and segment replays); then a collector that calls
    ``torch.distributed.all_reduce`` itself: the CaptureError's message
    (``direct/error``)."""
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = parallel.make_mesh(*map(int, arg.split(":")[1].split("x")))
    y = lg_data().to(device)
    prior = prior_from_spec(LG_PRIOR, device=device)
    for case, inner in (("systematic", smc.PFConfig()),
                        ("stratified", smc.PFConfig("stratified", 0.5))):
        sh = parallel.ShardedSMC2(smc.SMC2(smc.lg_model, prior, lg_cfg(inner=inner)), mesh)

        def run(sh=sh):
            state, (infos, series) = sh.run(torch.Generator(device=device).manual_seed(0), y,
                                            collect_fn=smc.expected_parameters)
            whole = sh.gather(state)
            return {**_theta_fields(whole), "particles": whole.particles, "log_w": whole.log_w,
                    "infos_ess": infos.ess, "series": series}

        for routed in (True, False):
            collective_stats.clear()
            with contextlib.nullcontext() if routed else smc.disable_graphs():
                res = {k: v.cpu() for k, v in run().items()}
            name = f"routed_{case}" if routed else case
            out.update(_flat(name, res))
            out[f"stats_{name}"] = np.asarray(_stats())
            if routed:
                out[f"routes_{case}"] = np.asarray(json.dumps(
                    [(key[0], r.cuts, r.replays, r.segment_replays, r.graphed)
                     for key, r in graphs._cache.items()]))
                graphs.clear_graphs()

    def direct(state):
        total = smc.expected_parameters(state).clone()
        torch.distributed.all_reduce(total)
        return total

    sh = parallel.ShardedSMC2(smc.SMC2(smc.lg_model, prior, lg_cfg()), mesh)
    try:
        sh.run(torch.Generator(device=device).manual_seed(0), y, collect_fn=direct)
    except graphs.CaptureError as err:
        out["direct/error"] = np.asarray(str(err))
    else:
        out["direct/error"] = np.asarray("")
    graphs.clear_graphs()


def suite_diverge(out: dict, world: int) -> None:
    """Rank 1 leaves the lockstep after 3 steps (as a rank whose host
    decision differed would) and stops calling collectives; every rank
    must end in an error within the process group's timeout."""
    model_fn, prior_spec, y, cfg = ROUTES["lg_systematic"]()
    sh = parallel.ShardedSMC2(smc.SMC2(model_fn, prior_from_spec(prior_spec, device="cpu"),
                                       cfg), parallel.make_mesh())
    gen = torch.Generator().manual_seed(0)
    state = sh.init(gen, y)
    rank = torch.distributed.get_rank()
    for k in range(y.shape[0] - 1):
        if rank == 1 and k == 3:
            time.sleep(DIVERGE_TIMEOUT_S + 1.0)
        t0 = time.perf_counter()
        try:
            state, _ = sh.step(gen, state, y)
        except RuntimeError as e:  # DistBackendError and gloo's errors
            out["error"] = np.asarray(repr(e)[:500])
            out["wait_s"] = np.asarray(time.perf_counter() - t0)
            return
    out["error"] = np.asarray("")


DIVERGE_TIMEOUT_S = 3.0


def start_world(suite: str, world: int, out_dir: Path):
    """Start ``world`` ranks of SUITE, one process each ("plain" takes
    world 1); :func:`wait_world` collects them."""
    import subprocess

    store = Path(out_dir) / "store"
    return out_dir, [subprocess.Popen([sys.executable, __file__, suite, str(r), str(world),
                                       str(store), str(out_dir)], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for r in range(world)]


def wait_world(handle, timeout_s: float = 300.0):
    """Wait for every rank of a started world, each within ``timeout_s``.
    Returns (the ranks' npz contents, their stdouts); raises if a rank
    failed, and kills any rank still running."""
    out_dir, procs = handle
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout_s)
            outs.append(out)
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{out}\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise AssertionError("\n".join(failed))
    return [dict(np.load(Path(out_dir) / f"{r}.npz")) for r in range(len(procs))], outs


def run_world(suite: str, world: int, out_dir: Path, timeout_s: float = 300.0):
    """:func:`start_world` then :func:`wait_world`."""
    return wait_world(start_world(suite, world, out_dir), timeout_s)


# the θ-only worlds' sizes; the (θ, particle) meshes that shard particles
# and their world sizes; every world test_torch_parallel.py and
# test_torch_mesh_graphs.py read: the one-process references, the θ-sharded
# worlds and the particle meshes
WORLDS = (2, 4)
PMESHES = {"1x2": 2, "2x2": 4, "1x4": 4}
WORLD_SPECS = {1: ("plain", 1), **{w: ("parallel", w) for w in WORLDS},
               **{shape: (f"particle:{shape}", w) for shape, w in PMESHES.items()}}


def shared_runs(tmp_path_factory, specs: dict, timeout_s: float = 600.0) -> dict:
    """The worlds ``specs`` ({key: (suite, world)}) run once per test
    session for every test file that asks (test_torch_parallel.py,
    test_torch_mesh_graphs.py), under pytest-xdist too: the first to ask
    starts them all under a file lock in the session's common temporary
    directory, and every asker reads their results. Returns {key: the
    ranks' npz contents}."""
    import fcntl
    import os

    base = tmp_path_factory.getbasetemp()
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = base.parent / f"torch_worlds_{uid}" if uid else base / "torch_worlds"
    root.mkdir(parents=True, exist_ok=True)
    dirs = {key: root / str(key) for key in specs}
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / "done").exists():
            handles = {}
            for key, (suite, world) in specs.items():
                dirs[key].mkdir(exist_ok=True)
                (dirs[key] / "store").unlink(missing_ok=True)
                handles[key] = start_world(suite, world, dirs[key])
            failed = []
            for handle in handles.values():
                try:
                    wait_world(handle, timeout_s)
                except AssertionError as err:
                    failed.append(str(err))
            if failed:
                raise AssertionError("\n".join(failed))
            (root / "done").write_text("")
    return {key: [dict(np.load(dirs[key] / f"{r}.npz")) for r in range(world)]
            for key, (_, world) in specs.items()}


def main() -> None:
    suite, rank, world, store, out_dir = sys.argv[1], *map(int, sys.argv[2:4]), *sys.argv[4:6]
    torch.set_num_threads(1)
    out: dict = {}
    t0 = time.perf_counter()
    if suite == "plain":
        suite_plain(out)
    else:
        name, _, arg = suite.partition(":")
        gpu = name == "gpu"  # "gpu:BACKEND:RθxRp": the ranks on the card
        parallel.initialize_distributed(
            init_method=f"file://{store}", num_processes=world, process_id=rank,
            device=None if gpu else "cpu", backend=arg.split(":")[0] if gpu else None,
            timeout_s=DIVERGE_TIMEOUT_S if suite == "diverge" else 120.0)
        globals()[f"suite_{name}"](out, world, *([arg] if arg else []))
        if suite != "diverge":
            torch.distributed.destroy_process_group()
    out["seconds"] = np.asarray(time.perf_counter() - t0)
    np.savez(Path(out_dir) / f"{rank}.npz", **out)


if __name__ == "__main__":
    main()
