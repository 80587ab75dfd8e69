"""The port's compiled particle-Gibbs chain (``ops/graphs.py``): one graph
a PG sweep (``pg_chain``: the complete-data MH steps, the adaptation, the
CSMC forward pass and the path draw), one graph a CSMC sweep
(``csmc_sweep``, behind ``csmc_sweep`` and ``csmc_forward``), and the
multinomial scheme on the filter routes (PG's initial forward bank).

On the CPU nothing is captured: with ``batched_filter.captures`` answering
as it would on the card (the ``routed`` fixture), every loop runs through
its route — the buffers, the loads, the sweep counter, the stores — with
each body run eagerly, and is held bit for bit against the eager loop. The
replays themselves are held against their ``disable_graphs()`` twins on the
card (the ``gpu`` cases at the end), which skip here. Only the posterior
test imports JAX, inside it, so that the card runs this file without JAX:

    python -m pytest --noconftest tests/test_torch_pg_graphs.py -m gpu
"""
import contextlib
import math

import numpy as np
import pytest
import torch

import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf
from sequential_monte_carlo_tpu_torch.ops import graphs
from sequential_monte_carlo_tpu_torch.samplers.particle_gibbs import _particle_gibbs_bank

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

S = graphs.STEPS_PER_GRAPH
UCSV_PRIOR = [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
              ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)]
LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
LG_THETA = (0.5, 0.9, 0.8)
UCSV_THETA = (0.2, 3.0, -1.0, -1.0)
MODELS = {"ucsv": (tsmc.ucsv_model, UCSV_PRIOR), "lg": (tsmc.lg_model, LG_PRIOR)}


def _series(t, kind="ucsv", seed=1998):
    """bench.py's synthetic inflation-like series (UC-SV), or an LG series
    at θ*, first t points."""
    rng = np.random.default_rng(seed)
    if kind == "ucsv":
        y = 3.0 + np.cumsum(rng.normal(0, 0.3, 241)) + rng.normal(0, 0.5, 241)
        return torch.from_numpy(y.astype(np.float32)[:t])
    a, q, r = LG_THETA
    x, ys = rng.normal(), []
    for _ in range(t):
        x = a * x + math.sqrt(q) * rng.normal()
        ys.append(x + math.sqrt(r) * rng.normal())
    return torch.tensor(ys, dtype=torch.float32)


@pytest.fixture
def routed(monkeypatch):
    """``captures`` as on the card: the loops take their routes on the CPU
    (the bodies run eagerly through the buffers)."""
    captures = tbf.captures
    monkeypatch.setattr(tbf, "captures", lambda config, active_n, device: captures(
        config, active_n, torch.device("cuda")))
    graphs.clear_graphs()
    yield
    graphs.clear_graphs()


def _routes(kind: str):
    return [r for key, r in graphs._cache.items() if key[0] == kind]


def _pg(kind, chains, cfg, seed, device="cpu", theta0=None):
    """One PG run: ``particle_gibbs`` at one chain, else ``chains`` chains
    as one bank from prior draws; the result's fields as a tuple."""
    model_fn, spec = MODELS[kind]
    prior = prior_from_spec(spec, device=device)
    y = _series(24, kind).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if chains == 1:
        res = tsmc.particle_gibbs(gen, model_fn, prior, y, cfg, theta0=theta0)
    else:
        res = _particle_gibbs_bank(gen, model_fn, prior, y, cfg,
                                   prior.sample(gen, (chains,)) if theta0 is None else theta0)
    return tuple(res), gen.get_state()


def _assert_equal(got, ref):
    for a, b in zip(graphs._leaves(got), graphs._leaves(ref), strict=True):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("switches", ["collect_adapt", "neither"])
@pytest.mark.parametrize("chains", [1, 3])
@pytest.mark.parametrize("method", ["bs", "as"])
@pytest.mark.parametrize("kind", ["ucsv", "lg"])
def test_pg_route_body_equals_eager(routed, kind, method, chains, switches):
    """Three PG sweeps through the PG route (one replay a sweep, the sweep
    counter, the θ/acceptance/path stores) and the initial paths' forward
    bank through the store route, bitwise the eager loop: θ chain,
    acceptances, final path, paths, the generator's state after."""
    on = switches == "collect_adapt"
    cfg = tsmc.PGConfig(n_particles=64, sweeps=3, chain=2, method=method, collect_paths=on,
                        adapt=on)
    got = _pg(kind, chains, cfg, 4)
    (pg,) = _routes("pg")
    assert pg.replays == 3 and int(pg.buffers.counter) == 3
    (stored,) = _routes("stored")
    assert stored.replays == 23 // S + 23 % S
    assert not _routes("csmc")  # the sweep's CSMC runs inside its graph
    with tsmc.disable_graphs():
        ref = _pg(kind, chains, cfg, 4)
    _assert_equal(got, ref)
    assert (got[0][3] is None) != on


@pytest.mark.parametrize("entry", ["sweep", "forward"])
@pytest.mark.parametrize("method", ["bs", "as"])
@pytest.mark.parametrize("kind", ["ucsv", "lg"])
def test_csmc_route_body_equals_eager(routed, kind, method, entry):
    """``csmc_sweep`` (both methods) and ``csmc_forward`` (with and without
    ancestor sampling) through the CSMC route, twice — the second from a
    new generator, reference path and θ on the cached route — bitwise the
    eager calls: path, clouds, filtered weights, ancestors, log Z."""
    model_fn = MODELS[kind][0]
    thetas = [torch.tensor(UCSV_THETA if kind == "ucsv" else LG_THETA), None]
    thetas[1] = thetas[0] * 0.9
    y = _series(24, kind)
    dx = 3 if kind == "ucsv" else 1
    refs = [torch.zeros((24, dx)), torch.from_numpy(
        np.random.default_rng(3).normal(size=(24, dx)).astype(np.float32))]

    def call(i):
        gen = torch.Generator().manual_seed(10 + i)
        model = model_fn(thetas[i])
        if entry == "sweep":
            return tuple(tsmc.csmc_sweep(gen, model, 48, y, refs[i], method=method))
        return tsmc.csmc_forward(gen, model, 48, y, refs[i], ancestor_sampling=method == "as")

    got = (call(0), call(1))
    (route,) = _routes("csmc")
    assert route.replays == 2
    with tsmc.disable_graphs():
        ref = (call(0), call(1))
    _assert_equal(got, ref)


@pytest.mark.parametrize("entry", ["forward_bank", "masked"])
def test_multinomial_filters_take_their_routes(routed, entry):
    """The multinomial scheme on the captured routes: PG's initial forward
    bank (``forward_clouds`` at ``PFConfig("multinomial")``) on the store
    route and the masked filter on its S-step and one-step graphs, bitwise
    the eager loops."""
    cfg = tsmc.PFConfig("multinomial")
    y = _series(2 * S + 5)
    theta = torch.tensor(np.random.default_rng(5).normal(UCSV_THETA, 0.05, (6, 4)),
                         dtype=torch.float32)

    def run(gen):
        if entry == "forward_bank":
            return tsmc.forward_clouds(gen, tsmc.ucsv_model(theta[0]), 64, y, cfg)
        return tsmc.batched_log_likelihood(gen, tsmc.ucsv_model(theta), 64, 6, y, cfg)

    got = run(torch.Generator().manual_seed(7))
    (route,) = _routes("stored" if entry == "forward_bank" else "masked")
    assert route.replays == (len(y) - 1) // S + (len(y) - 1) % S
    with tsmc.disable_graphs():
        ref = run(torch.Generator().manual_seed(7))
    _assert_equal(got, ref)


@pytest.mark.parametrize("kind", ["ucsv", "lg"])
def test_cached_pg_route_replays_a_new_generator_and_start(routed, kind):
    """A second run from a new generator and a new θ0 replays the cached PG
    route (no second route), and equals a fresh eager run from the same
    seed and θ0 bit for bit."""
    cfg = tsmc.PGConfig(n_particles=64, sweeps=3, chain=2, collect_paths=True)
    _pg(kind, 3, cfg, 1)
    theta0 = prior_from_spec(MODELS[kind][1], device="cpu").sample(
        torch.Generator().manual_seed(99), (3,))
    got = _pg(kind, 3, cfg, 2, theta0=theta0)
    (route,) = _routes("pg")
    assert route.replays == 6
    with tsmc.disable_graphs():
        ref = _pg(kind, 3, cfg, 2, theta0=theta0)
    _assert_equal(got, ref)


@pytest.mark.parametrize("case", ["lg_model", "uc_model", "univariate_numbers",
                                  "univariate_mixed", "multivariate", "sv", "ucsv"])
def test_constructor_fields_unchanged(case):
    """The constructors build a number as a fill on the tensor arguments'
    device (no copy from host memory) with the fields they built before by
    ``torch.as_tensor``: the same values, dtype, shape and device."""
    th = torch.tensor([[0.5, 0.9, 0.8], [0.7, 0.4, 1.3]])
    build = {
        "lg_model": (lambda: tsmc.lg_model(th),
                     lambda f: tsmc.LinearGaussianModel(
                         A=th[:, 0, None, None], B=f(1.0).expand(2)[:, None],
                         Q=th[:, 1, None, None], R=th[:, 2], x0=f(0.0).expand(2)[:, None],
                         sigma0=f(1.0).expand(2)[:, None, None])),
        "uc_model": (lambda: tsmc.uc_model(th),
                     lambda f: tsmc.LinearGaussianModel(
                         A=f(1.0).expand(2)[:, None, None], B=f(1.0).expand(2)[:, None],
                         Q=th[:, 1, None, None], R=th[:, 2], x0=th[:, 0, None],
                         sigma0=th[:, 1, None, None])),
        "univariate_numbers": (lambda: tsmc.univariate_linear_gaussian(0.5, 1.0, 0.9, 0.8,
                                                                       device="cpu"),
                               lambda f: tsmc.LinearGaussianModel(
                                   A=f(0.5)[None, None], B=f(1.0)[None], Q=f(0.9)[None, None],
                                   R=f(0.8), x0=f(0.0)[None], sigma0=f(1.0)[None, None])),
        "univariate_mixed": (lambda: tsmc.univariate_linear_gaussian(th[:, 0], 1.0, 0.3, th[:, 2],
                                                                     x0=0.1, sigma0=2.0),
                             lambda f: tsmc.LinearGaussianModel(
                                 A=th[:, 0, None, None], B=f(1.0).expand(2)[:, None],
                                 Q=f(0.3).expand(2)[:, None, None], R=th[:, 2],
                                 x0=f(0.1).expand(2)[:, None],
                                 sigma0=f(2.0).expand(2)[:, None, None])),
        "multivariate": (lambda: tsmc.multivariate_linear_gaussian(
            torch.eye(2) * 0.5, torch.tensor([1.0, 0.0]), 0.3, 0.8),
            lambda f: tsmc.LinearGaussianModel(
                A=torch.eye(2) * 0.5, B=torch.tensor([1.0, 0.0]), Q=f(0.3) * torch.eye(2),
                R=f(0.8), x0=f(0.0).expand(2).clone(), sigma0=f(1.0) * torch.eye(2))),
        "sv": (lambda: tsmc.stochastic_volatility(th[:, 0], 0.95, 0.3),
               lambda f: tsmc.StochasticVolatilityModel(mu=th[:, 0], phi=f(0.95), sigma=f(0.3))),
        "ucsv": (lambda: tsmc.unobserved_components_stochastic_volatility(
            th[:, 0], 0.2, th[:, 1], -1, 0.5),
            lambda f: tsmc.UCSVModel(gamma_eps=f(0.2), gamma_eta=th[:, 1], x0=th[:, 0],
                                     log_sigma_eps0=f(-1), log_sigma_eta0=f(0.5)))}
    new, old = build[case]
    got = new()
    want = old(lambda v: torch.as_tensor(v, dtype=torch.float32, device="cpu"))
    for f in ("A", "B", "Q", "R", "x0", "sigma0", "mu", "phi", "sigma", "gamma_eps",
              "gamma_eta", "log_sigma_eps0", "log_sigma_eta0"):
        if hasattr(want, f):
            a, b = getattr(got, f), getattr(want, f)
            assert a.shape == b.shape and a.dtype == b.dtype and a.device == b.device, f
            assert torch.equal(a, b), f


def test_eigh_models_keep_the_eager_pg_loop(routed):
    """An LG model at dx = 2 builds its kernel parameters by eigh, which
    reads the host: its PG chain keeps the eager sweep loop (no PG route),
    each sweep's CSMC on the CSMC route (its parameters packed outside the
    graph), bitwise the eager run."""
    def model_fn(th):
        return tsmc.multivariate_linear_gaussian(
            torch.stack([torch.stack([th[0], th[1] * 0.0 + 0.1]),
                         torch.stack([th[1] * 0.0, th[1] * 0.0 + 0.5])]),
            torch.stack([th[0] * 0.0 + 1.0, th[0] * 0.0]), 0.3, 0.8)

    prior = tsmc.product_distribution([tsmc.Uniform(torch.tensor(0.1), torch.tensor(0.9)),
                                       tsmc.Uniform(torch.tensor(0.0), torch.tensor(1.0))])
    assert model_fn(torch.tensor([0.5, 0.5])).params_read_host
    cfg = tsmc.PGConfig(n_particles=32, sweeps=3, chain=2)
    y = _series(16, "lg")

    def run():
        return tuple(tsmc.particle_gibbs(torch.Generator().manual_seed(3), model_fn, prior, y,
                                         cfg))

    got = run()
    assert not _routes("pg") and _routes("csmc")[0].replays == 3
    with tsmc.disable_graphs():
        ref = run()
    _assert_equal(got, ref)


def test_routed_pg_posterior_matches_jax():
    """Distributional tier, on ``tests/test_torch_particle_gibbs.py``'s LG
    problem (T=60, N=128, 400 sweeps, chain=3, 8 chains from prior draws,
    burn-in 150): the routed chains' pooled θ mean and the JAX package's
    ``particle_gibbs`` over 8 keys each within the JAX test's 0.3 of the
    prior-IS oracle (100,000 draws, Kalman log Z) and within 0.3 of each
    other; the mean acceptances within 0.05. (JAX is imported here: the
    card's tests run this file without it.)"""
    import jax
    import jax.numpy as jnp

    import chip_smoke
    import sequential_monte_carlo_tpu as jsmc

    y = chip_smoke.lg_series(60)
    prior = prior_from_spec(LG_PRIOR, device="cpu")
    theta = prior.sample(torch.Generator().manual_seed(77), (100_000,))
    _, lz = tsmc.kalman_log_likelihood(tsmc.lg_model(theta), torch.from_numpy(y))
    oracle = (torch.softmax(lz.double(), 0) @ theta.double()).numpy()
    cfg = dict(n_particles=128, sweeps=400, chain=3)
    with pytest.MonkeyPatch.context() as mp:
        captures = tbf.captures
        mp.setattr(tbf, "captures", lambda config, active_n, device: captures(
            config, active_n, torch.device("cuda")))
        graphs.clear_graphs()
        gen = torch.Generator().manual_seed(11)
        res = _particle_gibbs_bank(gen, tsmc.lg_model, prior, torch.from_numpy(y),
                                   tsmc.PGConfig(**cfg), prior.sample(gen, (8,)))
        assert _routes("pg")[0].replays == 400
        graphs.clear_graphs()
    f = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    jprior = jsmc.product_distribution([jsmc.TruncatedNormal(f(0.0), f(1.0), f(-1.0), f(1.0)),
                                        jsmc.LogNormal(f(0.0), f(1.0)),
                                        jsmc.LogNormal(f(0.0), f(1.0))])
    run = jax.jit(jax.vmap(lambda k: jsmc.particle_gibbs(k, jsmc.lg_model, jprior,
                                                         jnp.asarray(y), jsmc.PGConfig(**cfg))))
    jres = run(jax.random.split(jax.random.key(0), 8))
    port = res.theta[150:].mean(0).mean(0).numpy()
    ref = np.asarray(jres.theta)[:, 150:].mean(1).mean(0)
    assert np.all(np.abs(port - oracle) < 0.3), (port, oracle)
    assert np.all(np.abs(ref - oracle) < 0.3), (ref, oracle)
    assert np.all(np.abs(port - ref) < 0.3), (port, ref)
    acc, jacc = float(res.acc_ratio.mean()), float(np.asarray(jres.acc_ratio).mean())
    assert abs(acc - jacc) < 0.05, (acc, jacc)


# -- on the card: each replayed loop against its disable_graphs() twin --------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the graphs are captured and replayed on the card")
    graphs.clear_graphs()
    yield torch.device("cuda")
    graphs.clear_graphs()


def _counted(fn):
    from sequential_monte_carlo_tpu_torch.kernels import _build

    before = _build.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, [a - b for a, b in zip(_build.launch_counts(), before)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind, method, chains", [("ucsv", "bs", 1), ("ucsv", "as", 1),
                                                  ("ucsv", "as", 8), ("lg", "bs", 8)])
def test_pg_replays_equal_eager_on_the_card(cuda, kind, method, chains):
    """PG at N=1024 over 24 observations, 6 sweeps, replayed one graph a
    sweep: θ chain, acceptances, final path, paths, the generator's state
    and the launch counts equal the eager run's."""
    cfg = tsmc.PGConfig(n_particles=1024, sweeps=6, chain=2, method=method, collect_paths=True)
    runs = {}
    for mode in ("graphed", "eager"):
        with (tsmc.disable_graphs() if mode == "eager" else contextlib.nullcontext()):
            runs[mode] = _counted(lambda: _pg(kind, chains, cfg, 0, device=cuda))
    (route,) = _routes("pg")
    assert route.replays == 6
    _assert_equal(runs["graphed"][0], runs["eager"][0])
    assert runs["graphed"][1] == runs["eager"][1]


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["sweep_bs", "sweep_as", "forward"])
def test_csmc_replays_equal_eager_on_the_card(cuda, entry):
    """Iterated ``csmc_sweep`` (10 sweeps) and ``csmc_forward`` on UC-SV at
    N=2048, T=60, replayed, bitwise their eager runs with equal launch
    counts; one route, one replay a call."""
    model = tsmc.ucsv_model(torch.tensor(UCSV_THETA, device=cuda))
    y = _series(60).to(cuda)

    def run():
        gen, path, outs = torch.Generator(device=cuda).manual_seed(5), torch.zeros(
            (60, 3), device=cuda), []
        for _ in range(10):
            if entry == "forward":
                outs.append(tsmc.csmc_forward(gen, model, 2048, y, path))
            else:
                out = tsmc.csmc_sweep(gen, model, 2048, y, path, method=entry[-2:])
                path = out.path
                outs.append(tuple(out))
        return tuple(outs), gen.get_state()

    runs = {}
    for mode in ("graphed", "eager"):
        with (tsmc.disable_graphs() if mode == "eager" else contextlib.nullcontext()):
            runs[mode] = _counted(run)
    (route,) = _routes("csmc")
    assert route.replays == 10
    _assert_equal(runs["graphed"][0], runs["eager"][0])
    assert runs["graphed"][1] == runs["eager"][1]


@pytest.mark.gpu
def test_pg_one_launch_and_no_sync_a_sweep(cuda):
    """A graphed PG run (UC-SV, N=1024, T=24), its route already captured:
    one graph launch a sweep beside the initial forward bank's
    ⌊23/S⌋ + 23 mod S, and no host sync, at 4 and at 12 sweeps."""
    import chip_smoke

    prior = prior_from_spec(UCSV_PRIOR, device=cuda)  # copies from the host, outside the runs
    y = _series(24).to(cuda)
    counts = {}
    for sweeps in (4, 4, 12):
        cfg = tsmc.PGConfig(n_particles=1024, sweeps=sweeps, chain=2)
        gen = torch.Generator(device=cuda).manual_seed(sweeps)
        with chip_smoke.graph_calls(torch) as counts[sweeps]:
            tsmc.particle_gibbs(gen, tsmc.ucsv_model, prior, y, cfg)
        torch.cuda.synchronize()
    for sweeps in (4, 12):
        assert counts[sweeps] == {"graph_launches": sweeps + 23 // S + 23 % S,
                                  "host_syncs": 0}, counts


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8192, 65536])
def test_one_row_cdf_is_the_same_run_to_run(cuda, n):
    """The inverse CDF of one row of n weights (many of CUB's tiles), 300
    times while a second stream keeps the card busy: the same cdf bits and
    ancestors every time, and the row's cdf that a bank of rows computes."""
    from sequential_monte_carlo_tpu_torch.ops.resampling import _inverse_cdf, _row_cumsum

    gen = torch.Generator(device=cuda).manual_seed(n)
    w = torch.rand((1, n), generator=gen, device=cuda) ** 4
    u = torch.rand((1, n), generator=gen, device=cuda)
    first_cdf, first_anc = _row_cumsum(w), _inverse_cdf(u, w)
    busy, side = torch.rand((4096, 4096), device=cuda), torch.cuda.Stream()
    for _ in range(300):
        with torch.cuda.stream(side):
            busy.mul_(1.0)
        assert torch.equal(_row_cumsum(w), first_cdf)
        assert torch.equal(_inverse_cdf(u, w), first_anc)
    torch.cuda.synchronize()
    assert torch.equal(first_cdf[0], torch.cumsum(w.expand(3, n), dim=-1)[1])


@pytest.mark.gpu
def test_model_fn_copying_a_number_raises(cuda):
    """A ``model_fn`` that copies a Python number to the card inside the
    sweep cannot be captured: ``CaptureError`` naming it, no PG route kept;
    ``disable_graphs()`` runs it."""
    def copies_a_number(th):
        return tsmc.UCSVModel(gamma_eps=th[0], gamma_eta=torch.tensor(0.2, device=th.device),
                              x0=th[1], log_sigma_eps0=th[2], log_sigma_eta0=th[3])

    prior = prior_from_spec(UCSV_PRIOR, device=cuda)
    y = _series(20).to(cuda)
    cfg = tsmc.PGConfig(n_particles=256, sweeps=2, chain=1)
    with pytest.raises(graphs.CaptureError, match="copies_a_number"):
        tsmc.particle_gibbs(torch.Generator(device=cuda).manual_seed(0), copies_a_number, prior,
                            y, cfg)
    assert not _routes("pg")
    with tsmc.disable_graphs():
        res = tsmc.particle_gibbs(torch.Generator(device=cuda).manual_seed(0), copies_a_number,
                                  prior, y, cfg)
    assert res.theta.shape == (2, 4)
