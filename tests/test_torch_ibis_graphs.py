"""IBIS's compiled loops (``ops/graphs.py``): the Kalman bank's masked and
live loops and ``kalman_filter`` on their routes (S steps a launch), and
IBIS's online step replayed with one flag read a step.

On the CPU nothing is captured: with ``batched_filter.captures`` answering
as it would on the card (the ``routed`` fixture), every loop runs through
its route — the buffers, the loads, the flag reads, the stores and the
replays grouped as the graphs would launch them — with each step body run
eagerly, and is held bit for bit against the eager loop. The Kalman loops
are also held against the JAX package's scans (imported inside those
tests). The replays themselves are held against their ``disable_graphs()``
twins on the card (the ``gpu`` cases at the end), which skip here; the card
runs this file without JAX:

    python -m pytest --noconftest tests/test_torch_ibis_graphs.py -m gpu
"""
import contextlib

import numpy as np
import pytest
import torch

import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf
from sequential_monte_carlo_tpu_torch.ops import graphs
from sequential_monte_carlo_tpu_torch.ops import kalman as tkf

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

S = graphs.STEPS_PER_GRAPH
LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
IBIS_FIELDS = ("theta", "log_omega", "mean", "cov", "log_z", "ess", "acc_ratio")
# f32 against JAX's f32 scan: mean and cov to 1e-5 relative; log Z, a sum of
# T per-step terms of ~1, to 2e-6 a step
KALMAN_RTOL, LOGZ_ATOL_PER_STEP = 1e-5, 2e-6


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


def _bank(m=24, t=2 * S + 8, seed=0, device="cpu"):
    """An LG θ-bank (A, Q, R) and a series, from a numpy seed."""
    rng = np.random.default_rng(seed)
    theta = np.stack([rng.uniform(-0.9, 0.9, m), rng.uniform(0.2, 2.0, m),
                      rng.uniform(0.2, 2.0, m)], 1).astype(np.float32)
    y = rng.normal(0.0, 1.5, t).astype(np.float32)
    return theta, y, tsmc.lg_model(torch.tensor(theta, device=device)), torch.tensor(y,
                                                                                    device=device)


def _equal(a, b):
    (sa, za), (sb, zb) = a, b
    return {"mean": torch.equal(sa.mean, sb.mean), "cov": torch.equal(sa.cov, sb.cov),
            "log_z": torch.equal(za, zb), "shapes": (sa.mean.shape, sa.cov.shape, za.shape)
            == (sb.mean.shape, sb.cov.shape, zb.shape)}


@pytest.mark.parametrize("live", [0, 1, S - 1, S, S + 1, 2 * S + 3])
def test_kalman_live_route_equals_eager(routed, live):
    """The Kalman bank over the first L observations (IBIS's rejuvenation
    pass) replays ⌊L/S⌋ launches of the S-step graph and L mod S one-step
    launches, bitwise the eager loop, for L = 0, 1, S − 1, S, S + 1, 2S + 3."""
    _, _, models, y = _bank()
    got = tkf.live_log_likelihood(models, y, live, True)
    (route,) = _routes("kalman")
    assert route.replays == live // S + live % S
    ref = tkf.live_log_likelihood(models, y, live, False)
    assert all(_equal(got, ref).values()), _equal(got, ref)


@pytest.mark.parametrize("mask_kind", ["holes", "prefix", "bool_holes"])
def test_kalman_masked_route_equals_eager(routed, mask_kind):
    """``kalman_log_likelihood_masked`` with a mask with holes (as f32 and
    as bool) and with a prefix mask: all T steps on the masked route (the
    steps where mask ≤ 0 the identity), bitwise its eager loop; a prefix
    mask also bitwise the live route over that prefix."""
    _, _, models, y = _bank()
    t = y.shape[0]
    rng = np.random.default_rng(11)
    mask = (torch.arange(t) < S + 3).float() if mask_kind == "prefix" else torch.tensor(
        rng.integers(0, 2, t), dtype=torch.float32)
    if mask_kind == "bool_holes":
        mask = mask > 0
    got = tsmc.kalman_log_likelihood_masked(models, y, mask)
    (route,) = _routes("kalman")
    assert route.replays == t // S + t % S
    with tsmc.disable_graphs():
        ref = tsmc.kalman_log_likelihood_masked(models, y, mask)
    assert all(_equal(got, ref).values()), _equal(got, ref)
    if mask_kind == "prefix":
        live = tkf.live_log_likelihood(models, y, S + 3, True)
        assert all(_equal(got, live).values())


def test_kalman_filter_store_route_equals_eager(routed):
    """``kalman_filter`` through its store route (each step's mean, cov and
    log-likelihood written at its t) and ``kalman_log_likelihood`` through
    the live route, bitwise their eager loops."""
    _, _, models, y = _bank()
    got = tsmc.kalman_filter(models, y)
    got_ll = tsmc.kalman_log_likelihood(models, y)
    kinds = sorted(key[1] for key in graphs._cache if key[0] == "kalman")
    assert kinds == ["live", "stored"]
    with tsmc.disable_graphs():
        ref = tsmc.kalman_filter(models, y)
        ref_ll = tsmc.kalman_log_likelihood(models, y)
    for a, b in zip(got, ref, strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
    assert all(_equal(got_ll, ref_ll).values())


def _jax_bank(theta, y):
    import jax
    import jax.numpy as jnp

    import sequential_monte_carlo_tpu as jsmc

    return jax, jnp, jsmc, jax.vmap(jsmc.lg_model)(jnp.asarray(theta)), jnp.asarray(y)


def test_kalman_masked_matches_jax(routed):
    """The masked route against JAX's ``kalman_log_likelihood_masked``
    vmapped over the bank, same θ, series and mask from a numpy seed: mean
    and cov to rtol 1e-5, log Z to 2e-6·T."""
    theta, y_np, models, y = _bank(seed=4)
    mask_np = np.random.default_rng(5).integers(0, 2, y_np.shape[0]).astype(np.float32)
    (mean, cov), logz = tsmc.kalman_log_likelihood_masked(models, y, torch.tensor(mask_np))
    assert _routes("kalman")
    jax, jnp, jsmc, mj, yj = _jax_bank(theta, y_np)
    (mean_j, cov_j), logz_j = jax.vmap(
        lambda m: jsmc.kalman_log_likelihood_masked(m, yj, jnp.asarray(mask_np)))(mj)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=KALMAN_RTOL, atol=1e-6)
    np.testing.assert_allclose(cov.numpy(), np.asarray(cov_j), rtol=KALMAN_RTOL, atol=1e-6)
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_j), rtol=0,
                               atol=LOGZ_ATOL_PER_STEP * y_np.shape[0])


def test_kalman_filter_matches_jax(routed):
    """The store route against JAX's ``kalman_filter`` vmapped over the
    bank: every step's mean and cov to rtol 1e-5, its log-likelihood and
    log Z to 2e-6 a step."""
    theta, y_np, models, y = _bank(seed=6)
    means, covs, lls, logz = tsmc.kalman_filter(models, y)
    assert _routes("kalman")
    jax, _, jsmc, mj, yj = _jax_bank(theta, y_np)
    means_j, covs_j, lls_j, logz_j = jax.vmap(lambda m: jsmc.kalman_filter(m, yj))(mj)
    # JAX's vmapped outputs carry θ first: (M, T, ...)
    np.testing.assert_allclose(means.numpy(), np.moveaxis(np.asarray(means_j), 0, 1),
                               rtol=KALMAN_RTOL, atol=1e-6)
    np.testing.assert_allclose(covs.numpy(), np.moveaxis(np.asarray(covs_j), 0, 1),
                               rtol=KALMAN_RTOL, atol=1e-6)
    np.testing.assert_allclose(lls.numpy(), np.moveaxis(np.asarray(lls_j), 0, 1), rtol=0,
                               atol=LOGZ_ATOL_PER_STEP)
    np.testing.assert_allclose(logz.numpy(), np.asarray(logz_j), rtol=0,
                               atol=LOGZ_ATOL_PER_STEP * y_np.shape[0])


def _ibis(m=32, chain=2, device="cpu"):
    return tsmc.IBIS(tsmc.lg_model, prior_from_spec(LG_PRIOR, device=device),
                     tsmc.SMCConfig(n_theta=m, chain=chain))


def _series(t=30, device="cpu"):
    return torch.tensor(np.random.default_rng(1998).normal(0.0, 1.5, t).astype(np.float32),
                        device=device)


def _drive(ibis, entry, gen, y):
    if entry == "run":
        return ibis.run(gen, y)
    state, infos = ibis.init(gen, y), []
    for _ in range(len(y) - 1):
        state, info = ibis.step(gen, state, y)
        infos.append(info)
    return state, tsmc.StepInfo(*(torch.stack(list(f)) for f in zip(*infos)))


def _kalman_launches(infos, chain: int) -> int:
    """The Kalman route's launches of a run: at each rejuvenation at t,
    ``chain`` passes over t observations, ⌊t/S⌋ + t mod S each."""
    ts = (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist()
    return sum(chain * (t // S + t % S) for t in ts)


def _assert_ibis_equal(got, ref):
    for k in IBIS_FIELDS:
        assert torch.equal(getattr(got[0], k), getattr(ref[0], k)), k
    assert got[0].t == ref[0].t
    for k in got[1]._fields:
        a, b = getattr(got[1], k), getattr(ref[1], k)
        assert a.shape == b.shape and a.device == b.device and torch.equal(a, b), k


@pytest.mark.parametrize("entry", ["run", "step"])
def test_ibis_online_body_equals_eager(routed, entry):
    """IBIS over 29 online steps with rejuvenations through its online route
    (one flag read and one replay a step, the rejuvenations between them,
    each proposal's Kalman pass on the live route), driven by ``run`` or by
    ``step``, bitwise the eager loop: state and every StepInfo."""
    ibis, y = _ibis(), _series()
    got = _drive(ibis, entry, torch.Generator().manual_seed(0), y)
    (online,) = _routes("ibis")
    assert online.replays == online.buffers.reads == len(y) - 1
    (kalman,) = _routes("kalman")
    assert kalman.replays == _kalman_launches(got[1], 2)
    with tsmc.disable_graphs():
        ref = _drive(ibis, entry, torch.Generator().manual_seed(0), y)
    assert ref[1].rejuvenated.sum() >= 2, "the series should degenerate the θ-cloud"
    _assert_ibis_equal(got, ref)


def test_ibis_step_returns_a_state_that_owns_its_arrays(routed):
    """A state returned by IBIS's ``step`` on its route owns its arrays: a
    later step leaves it as it was, and none of its tensors shares storage
    with the route's buffers."""
    ibis, y = _ibis(), _series(10)
    gen = torch.Generator().manual_seed(2)
    state1, _ = ibis.step(gen, ibis.init(gen, y), y)
    kept = {k: getattr(state1, k).clone() for k in IBIS_FIELDS}
    state2, _ = ibis.step(gen, state1, y)
    for k, v in kept.items():
        assert torch.equal(getattr(state1, k), v), k
    (route,) = _routes("ibis")
    b = route.buffers
    ptrs = {x.untyped_storage().data_ptr() for x in (*b.mean, *b.cov, b.log_omega, b.log_z,
                                                     b.ess)}
    for st in (state1, state2):
        assert not ptrs & {getattr(st, k).untyped_storage().data_ptr() for k in IBIS_FIELDS}


def test_ibis_routed_posterior_matches_oracle(routed):
    """IBIS through its routes (M=256, chain=3) on a simulated LG series
    recovers the exact prior-IS posterior mean (100,000 θ weighted by the
    Kalman likelihood, itself on the live route) within 0.3, as
    ``tests/test_torch_ibis.py`` holds the eager sampler."""
    theta_true = torch.tensor([[0.5, 0.9, 0.8]])
    y = _simulate(tsmc.lg_model(theta_true), 100)
    prior = prior_from_spec(LG_PRIOR, device="cpu")
    draws = prior.sample(torch.Generator().manual_seed(77), (100_000,))
    _, lz = tsmc.kalman_log_likelihood(tsmc.lg_model(draws), y)
    oracle = (torch.softmax(lz.double(), 0) @ draws.double()).numpy()
    state, infos = tsmc.IBIS(tsmc.lg_model, prior, tsmc.SMCConfig(n_theta=256, chain=3)).run(
        torch.Generator().manual_seed(6), y)
    assert bool(infos.rejuvenated.any()) and _routes("ibis")[0].replays == 99
    got = tsmc.expected_parameters(state).numpy()
    assert np.all(np.abs(got - oracle) < 0.3), (got, oracle)


def _simulate(model, t: int, seed: int = 1998):
    """One LG path's observations from a numpy seed (model of one θ row)."""
    rng = np.random.default_rng(seed)
    a, q, r = (float(model.A.flatten()[0]), float(model.Q.flatten()[0]),
               float(model.R.flatten()[0]))
    x, ys = rng.normal(0.0, 1.0), []
    for _ in range(t):
        x = a * x + rng.normal(0.0, np.sqrt(q))
        ys.append(x + rng.normal(0.0, np.sqrt(r)))
    return torch.tensor(np.array(ys, np.float32))


# -- on the card: each replayed loop against its disable_graphs() twin --------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the graphs are captured and replayed on the card")
    graphs.clear_graphs()
    yield torch.device("cuda")
    graphs.clear_graphs()


@pytest.mark.gpu
def test_ibis_replays_equal_eager_on_the_card(cuda):
    """IBIS LG at 512 θ, chain 3, over 100 observations replayed from its
    route: state and StepInfo equal the eager run's; one replay and one flag
    read an online step; the Kalman route's launches as counted; no kernel
    of the port launched."""
    from sequential_monte_carlo_tpu_torch.kernels import _build

    ibis, y = _ibis(512, 3, "cuda"), _series(100, "cuda")
    runs = {}
    for mode in ("graphed", "eager"):
        before = _build.launch_counts()
        with (tsmc.disable_graphs() if mode == "eager" else contextlib.nullcontext()):
            runs[mode] = ibis.run(torch.Generator(device=cuda).manual_seed(0), y)
        torch.cuda.synchronize()
        assert _build.launch_counts() == before
    (online,) = _routes("ibis")
    assert online.graphed and online.replays == online.buffers.reads == len(y) - 1
    (kalman,) = _routes("kalman")
    assert kalman.graphed and kalman.replays == _kalman_launches(runs["graphed"][1], 3)
    _assert_ibis_equal(runs["graphed"], runs["eager"])


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["kalman_filter", "masked", "live"])
def test_kalman_replays_equal_eager_on_the_card(cuda, entry):
    """``kalman_filter``, the masked pass (a mask with holes, on the card)
    and the live pass at 512 θ over 100 observations, replayed, equal their
    eager runs bit for bit; ⌊L/S⌋ + L mod S replays."""
    _, _, models, y = _bank(512, 100, 3, "cuda")
    mask = torch.tensor(np.random.default_rng(2).integers(0, 2, 100), dtype=torch.float32,
                        device=cuda)
    calls = {"kalman_filter": lambda: tsmc.kalman_filter(models, y),
             "masked": lambda: tsmc.kalman_log_likelihood_masked(models, y, mask),
             "live": lambda: tkf.live_log_likelihood(models, y, 77, tbf.captures(
                 tsmc.PFConfig(), None, cuda))}
    got = calls[entry]()
    with tsmc.disable_graphs():
        ref = calls[entry]()
    (route,) = _routes("kalman")
    steps = 77 if entry == "live" else 100
    assert route.graphed and route.replays == steps // S + steps % S
    for a, b in zip(graphs._leaves(tuple(got)), graphs._leaves(tuple(ref)), strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
