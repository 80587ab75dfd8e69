"""The elastic live count on the port's replays (``ops/graphs.py``): SMC²'s
"full" padding, one captured route per live count — the online step (its
doubling inside the step, its collector), the rejuvenations' masked
filters and the exchange's refilter at the doubled count — and
``batched_log_likelihood(_masked)(active_n=)``.

On the CPU nothing is captured: with ``batched_filter.captures`` answering
as it would on the card (the ``routed`` fixture), every loop runs through
its routes — the buffers, the loads, the flag reads, the stores and the
replays grouped as the graphs would launch them — with each step body run
eagerly, and is held bit for bit against the eager loop. The replays
themselves are held against their ``disable_graphs()`` twins on the card
(the ``gpu`` cases at the end), which skip here. Only the posterior test
imports JAX, inside it, so that the card runs this file without JAX:

    python -m pytest --noconftest tests/test_torch_elastic_graphs.py -m gpu
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

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

S = graphs.STEPS_PER_GRAPH
PRIORS = {"ucsv": [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
                   ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)],
          "lg": [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
                 ("lognormal", 0.0, 1.0)]}
MODELS = {"ucsv": tsmc.ucsv_model, "lg": tsmc.lg_model}
INNER = {"systematic": ("systematic", 1.0), "stratified_ess": ("stratified", 0.5),
         "multinomial": ("multinomial", 1.0)}
STATE_FIELDS = ("theta", "log_omega", "particles", "log_w", "log_z", "ess", "acc_ratio")
N0, T = 32, 24  # the live count at init, doubling twice to the cap 4·N0; observations


def _series(t, seed=1998):
    """bench.py's synthetic inflation-like series, first t points."""
    rng = np.random.default_rng(seed)
    y = 3.0 + np.cumsum(rng.normal(0, 0.3, 241)) + rng.normal(0, 0.5, 241)
    return torch.from_numpy(y.astype(np.float32)[:t])


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


def _full(model, n=N0, m=16, chain=2, inner="systematic", device="cpu"):
    """SMC² with the exchange armed in "full" padding: it fires after every
    rejuvenation while the live count is ≤ 2n, so the arrays are 4n wide and
    the live count runs n → 2n → 4n."""
    return tsmc.SMC2(MODELS[model], prior_from_spec(PRIORS[model], device=device),
                     tsmc.SMCConfig(n_particles=n, n_theta=m, chain=chain, acc_threshold=1.1,
                                    exchange_max_n=2 * n, elastic_pad="full",
                                    inner=tsmc.PFConfig(*INNER[inner])))


def _collect(state):
    """Per step: the live count (a fill: the route's host int), each row's
    live slots (finite log-weights), t and the posterior mean."""
    return {"active_n": torch.full((), state.active_n, device=state.log_w.device),
            "live": torch.isfinite(state.log_w).sum(-1), "t": state.t,
            "mean": tsmc.expected_parameters(state)}


def _drive(sampler, driver, gen, y):
    """(state, infos, per-step series or None) of a whole run by ``driver``:
    ``step`` (init + step, the live count after each step as its series),
    ``run``, ``run_segmented``, or ``collector`` (``run_segmented`` with
    :func:`_collect`)."""
    if driver == "step":
        state, infos, sizes = sampler.init(gen, y), [], []
        for _ in range(1, y.shape[0]):
            state, info = sampler.step(gen, state, y)
            infos.append(info)
            sizes.append(state.active_n)
        return state, tsmc.StepInfo(*(torch.stack(list(f)) for f in zip(*infos))), sizes
    if driver == "run":
        return sampler.run(gen, y) + (None,)
    if driver == "run_segmented":
        return sampler.run_segmented(gen, y, segment_size=8) + (None,)
    state, (infos, series) = sampler.run_segmented(gen, y, collect_fn=_collect)
    return state, infos, series


def _assert_states_equal(a, b):
    for k in STATE_FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert (a.t, a.active_n, a.exchange_pending) == (b.t, b.active_n, b.exchange_pending)


def _assert_trees_equal(a, b):
    for x, z in zip(graphs._leaves(a), graphs._leaves(b), strict=True):
        assert x.shape == z.shape and x.dtype == z.dtype and torch.equal(x, z)


def _routes(kind: str):
    return [r for key, r in graphs._cache.items() if key[0] == kind]


def _live_counts(kind: str) -> list:
    return sorted(r.buffers.active_n for r in _routes(kind))


@pytest.mark.parametrize("driver", ["step", "run", "run_segmented", "collector"])
@pytest.mark.parametrize("model", ["lg", "ucsv"])
def test_full_padding_online_route_equals_eager(routed, model, driver):
    """A "full"-padding run whose live count doubles twice inside its
    steps, driven by ``step``, ``run``, ``run_segmented`` with and without a
    collector, through the online route of each live count: state, every
    StepInfo and the series (the live count after each step; the
    collector's outputs, its live count the route's) bitwise the eager
    loop; one replay and one flag read a step over the routes."""
    sampler, y = _full(model), _series(T)
    got = _drive(sampler, driver, torch.Generator().manual_seed(1), y)
    online = _routes("online")
    assert sum(r.replays for r in online) == sum(r.buffers.reads for r in online) == T - 1
    assert _live_counts("online") == [N0, 2 * N0, 4 * N0]
    assert all(r.buffers.clouds[0].shape[-1] == 4 * N0 for r in online)
    with tsmc.disable_graphs():
        ref = _drive(sampler, driver, torch.Generator().manual_seed(1), y)
    assert ref[0].active_n == 4 * N0 and ref[0].particles.shape[1] == 4 * N0
    _assert_states_equal(got[0], ref[0])
    _assert_trees_equal(got[1], ref[1])
    # the live counts the steps ran at: those of the routes that replayed
    # (the first count's only where no doubling fired in the first step)
    stepped = sorted(r.buffers.active_n for r in online if r.replays)
    assert stepped[-2:] == [2 * N0, 4 * N0]
    if driver == "step":
        assert got[2] == ref[2] and sorted(set(got[2])) == stepped
    elif driver == "collector":
        _assert_trees_equal(got[2], ref[2])
        sizes = got[2]["active_n"]
        assert sizes.dtype == torch.int64 and sorted(set(sizes.tolist())) == stepped
        assert torch.equal(got[2]["live"], sizes[:, None].expand_as(got[2]["live"]))
        assert torch.equal(got[2]["t"], torch.arange(2, T + 1))


@pytest.mark.parametrize("model", ["lg", "ucsv"])
def test_full_padding_split_run_resumes_bitwise(routed, model):
    """``run_segmented`` with a collector split by ``max_steps`` after the
    first doubling and resumed with ``state=``, on the routes: the final
    state, the infos and series of both calls together bitwise the whole
    eager run's, and the split eager run's."""
    sampler, y = _full(model), _series(T)

    def split(gen):
        state, (i1, s1) = sampler.run_segmented(gen, y, collect_fn=_collect, max_steps=12)
        mid = state
        state, (i2, s2) = sampler.run_segmented(gen, y, collect_fn=_collect, state=state)
        infos = tsmc.StepInfo(*(torch.cat(pair) for pair in zip(i1, i2)))
        series = {k: torch.cat([s1[k], s2[k]]) for k in s1}
        return state, infos, series, mid

    got = split(torch.Generator().manual_seed(1))
    assert got[3].t == 13 and N0 < got[3].active_n
    with tsmc.disable_graphs():
        ref_split = split(torch.Generator().manual_seed(1))
        whole = _drive(sampler, "collector", torch.Generator().manual_seed(1), y)
    for ref in (ref_split, whole):
        _assert_states_equal(got[0], ref[0])
        _assert_trees_equal(got[1], ref[1])
        _assert_trees_equal(got[2], ref[2])
    _assert_states_equal(got[3], ref_split[3])


@pytest.mark.parametrize("entry", ["masked", "whole"])
@pytest.mark.parametrize("inner", sorted(INNER))
def test_elastic_masked_filter_equals_eager(routed, inner, entry):
    """``batched_log_likelihood_masked`` over live times with holes, and
    ``batched_log_likelihood`` over all of y, at a live count below N and no
    power of two (24 of 64) through the route of that count: particles,
    log-weights and log Z bitwise the eager loop, the dead tail exactly
    −inf; ⌊L/S⌋ + L mod S replays for L live times. A second live count
    takes a route of its own."""
    m, n, active, t = 6, 64, 24, 2 * S + 6
    theta = torch.tensor(np.random.default_rng(0).uniform(0.3, 0.9, (m, 3)), dtype=torch.float32)
    models, y, cfg = tsmc.lg_model(theta), _series(t), tsmc.PFConfig(*INNER[inner])
    mask = torch.ones(t)
    if entry == "masked":
        mask[torch.tensor([3, 4, 9, 15])] = 0.0

    def run(gen, live_n):
        if entry == "masked":
            return tbf.batched_log_likelihood_masked(gen, models, n, m, y, mask, cfg, live_n)
        return tbf.batched_log_likelihood(gen, models, n, m, y, cfg, active_n=live_n)

    got = run(torch.Generator().manual_seed(3), active)
    steps = int(mask[1:].sum())
    (route,) = _routes("masked")
    assert route.buffers.active_n == active and route.replays == steps // S + steps % S
    with tsmc.disable_graphs():
        ref = run(torch.Generator().manual_seed(3), active)
    for name, a, b in zip(("particles", "log_w", "log_z"), got, ref):
        assert torch.equal(a, b), name
    assert torch.all(got[1][:, active:] == -torch.inf)
    assert torch.all(torch.isfinite(got[1][:, :active])) and torch.all(torch.isfinite(got[2]))
    again = run(torch.Generator().manual_seed(3), 2 * active)
    assert _live_counts("masked") == [active, 2 * active]
    with tsmc.disable_graphs():
        ref = run(torch.Generator().manual_seed(3), 2 * active)
    for name, a, b in zip(("particles", "log_w", "log_z"), again, ref):
        assert torch.equal(a, b), name


def test_full_run_makes_one_route_per_live_count(routed, monkeypatch):
    """A run crossing each doubling captures one route per (kind, live
    count) — the masked filter and the online step at N0, 2N0 and 4N0 — and
    a second run captures none. Were the key to drop the live count
    (``_key`` patched so), the routes of the first count would replay the
    later counts' steps: fewer routes, and a run that parts from the eager
    loop — the failure this test is here to catch."""
    sampler, y = _full("ucsv"), _series(T)
    captured = []
    capture = graphs._Route.capture
    monkeypatch.setattr(graphs._Route, "capture", lambda self, *args: (
        captured.append(self), capture(self, *args))[1])
    got = sampler.run(torch.Generator().manual_seed(1), y)
    pairs = sorted((key[0], r.buffers.active_n) for key, r in graphs._cache.items())
    counts = [N0, 2 * N0, 4 * N0]
    assert pairs == [("masked", c) for c in counts] + [("online", c) for c in counts]
    assert len(captured) == len(pairs) <= graphs.CACHE_SIZE
    again = sampler.run(torch.Generator().manual_seed(1), y)
    assert len(captured) == len(pairs)
    _assert_states_equal(got[0], again[0])
    with tsmc.disable_graphs():
        ref = sampler.run(torch.Generator().manual_seed(1), y)
    _assert_states_equal(got[0], ref[0])

    key = graphs._key
    monkeypatch.setattr(graphs, "_key", lambda *args: key(*args)[:-1] + (None,))
    graphs.clear_graphs()
    wrong = sampler.run(torch.Generator().manual_seed(1), y)
    assert len(graphs._cache) == 2 and _live_counts("online") == [N0]
    assert not torch.equal(wrong[0].log_z, ref[0].log_z)


# JAX's SMC² on LG with the exchange in "full" padding at M=64, N=32 → 128,
# T=30, chain=2, over jax.random.key(0..31) on the CPU (its inner filter at
# fused_resample="off"), and the port's routed run over seeds 0..31: the
# larger of the two packages' seed spreads of the posterior mean.
FULL_LG_SD = np.array([0.09042, 0.08273, 0.11756])


def test_full_padding_posterior_matches_jax(routed):
    """Posterior tier: the mean over 8 seeds of the routed "full"-padding LG
    run's posterior mean against the same for the JAX package's
    ``SMC2(elastic_pad="full")`` (its inner filter at
    ``PFConfig(fused_resample="off")``, the CPU reference), within
    5·sd·√(2/8). (JAX is imported here: the card's tests run this file
    without it.)"""
    import jax
    import jax.numpy as jnp

    import sequential_monte_carlo_tpu as jsmc

    m, n, t, seeds = 64, 32, 30, 8
    _, y = jsmc.simulate(jax.random.key(1998), jsmc.lg_model(jnp.array([0.5, 0.9, 0.8])), 100)
    y = np.array(y, np.float32)[:t]
    cfg = dict(n_particles=n, n_theta=m, chain=2, ess_threshold=0.5, acc_threshold=1.1,
               exchange_max_n=2 * n, elastic_pad="full")
    prior = jsmc.product_distribution([jsmc.TruncatedNormal(0.0, 1.0, -1.0, 1.0),
                                       jsmc.LogNormal(0.0, 1.0), jsmc.LogNormal(0.0, 1.0)])
    jax_sampler = jsmc.SMC2(jsmc.lg_model, prior, jsmc.SMCConfig(
        **cfg, inner=jsmc.PFConfig("systematic", 1.0, fused_resample="off")))
    port = tsmc.SMC2(tsmc.lg_model, prior_from_spec(PRIORS["lg"], device="cpu"),
                     tsmc.SMCConfig(**cfg))
    jax_means, port_means = [], []
    for s in range(seeds):
        st_j, _ = jax_sampler.run(jax.random.key(s), jnp.asarray(y))
        assert int(st_j.active_n) == 4 * n
        jax_means.append(np.asarray(jsmc.expected_parameters(st_j)))
        st, infos = port.run(torch.Generator().manual_seed(s), torch.from_numpy(y))
        assert st.active_n == 4 * n and infos.ess.shape == (t - 1,)
        port_means.append(tsmc.expected_parameters(st).numpy())
    assert _live_counts("online") == [n, 2 * n, 4 * n]
    assert sum(r.replays for r in _routes("online")) == seeds * (t - 1)
    diff = np.mean(port_means, 0) - np.mean(jax_means, 0)
    tol = 5 * FULL_LG_SD * math.sqrt(2 / seeds)
    assert np.all(np.abs(diff) <= tol), (diff, tol)


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
@pytest.mark.parametrize("driver", ["step", "run", "collector"])
def test_full_padding_replays_equal_eager_on_the_card(cuda, driver):
    """SMC² UC-SV with 512 θ in "full" padding (arrays 512×1024, the live
    count 256 → 512 → 1024) over 40 observations, replayed from the online
    and masked routes of each live count: state, StepInfo, the series, the
    generator's state and the launch counts equal the eager run's; one
    route per (kind, live count)."""
    sampler = _full("ucsv", n=256, m=512, chain=2, device="cuda")
    y = _series(40).to(cuda)
    runs = {}
    for mode in ("graphed", "eager"):
        gen = torch.Generator(device=cuda).manual_seed(0)
        with (tsmc.disable_graphs() if mode == "eager" else contextlib.nullcontext()):
            out, counts = _counted(lambda: _drive(sampler, driver, gen, y))
        runs[mode] = (out, counts, gen.get_state())
    (got, counts_g, gen_g), (ref, counts_e, gen_e) = runs["graphed"], runs["eager"]
    assert ref[0].active_n == 1024
    online = _routes("online")
    assert all(r.graphed for r in online) and _live_counts("online") == [256, 512, 1024]
    assert _live_counts("masked") == [256, 512, 1024]
    _assert_states_equal(got[0], ref[0])
    _assert_trees_equal(got[1], ref[1])
    if driver == "step":
        assert got[2] == ref[2]
    elif driver == "collector":
        _assert_trees_equal(got[2], ref[2])
    assert counts_g == counts_e and torch.equal(gen_g, gen_e)


@pytest.mark.gpu
@pytest.mark.parametrize("active", [1000, 4096])
def test_elastic_filter_replays_equal_eager_on_the_card(cuda, active):
    """``batched_log_likelihood`` of 512 UC-SV filters padded to 8192 at a
    live count of 1000 (no power of two: the grid's divisor and log
    active_n stay host scalars in the graph, as in the eager step) and 4096,
    T=60, replayed: particles, log-weights, log Z and the launch counts
    equal the eager run's; the dead tail exactly −inf."""
    theta = torch.tensor(np.random.default_rng(1).normal([0.2, 3.0, -1.0, -1.0], 0.05,
                                                         (512, 4)), dtype=torch.float32,
                         device=cuda)
    models, y = tsmc.ucsv_model(theta), _series(60).to(cuda)
    runs = {}
    for mode in ("graphed", "eager"):
        with (tsmc.disable_graphs() if mode == "eager" else contextlib.nullcontext()):
            runs[mode] = _counted(lambda: tsmc.batched_log_likelihood(
                torch.Generator(device=cuda).manual_seed(2), models, 8192, 512, y,
                active_n=active))
    (route,) = _routes("masked")
    assert route.graphed and route.buffers.active_n == active
    for a, b in zip(runs["graphed"][0], runs["eager"][0]):
        assert torch.equal(a, b)
    assert runs["graphed"][1] == runs["eager"][1]
    assert torch.all(runs["graphed"][0][1][:, active:] == -torch.inf)
