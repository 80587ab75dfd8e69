"""The masked filter's captured step (``ops/graphs.py``) on the CPU: the body
a CUDA graph captures, run eagerly through the graph's own buffers (the
ping-pong clouds the kernels' ``out=`` write, y taken at the live time under
the position counter, every θ bank's fields copied in), against today's
eager loop bit for bit; the wrappers' ``out=`` plain versions against their
allocating ones; which routes are captured; ``disable_graphs``; and the
log Z through the buffers against the JAX package's masked filter. The
replays themselves need the card (``tests/test_torch_gpu.py``)."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sequential_monte_carlo_tpu as jsmc
from sequential_monte_carlo_tpu.ops.batched_filter import (
    batched_log_likelihood_masked as jax_loglik_masked,
)
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.kernels.propagate import fused_elementwise_step
from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
    resample_gather_sorted,
    stratified_uniforms,
)
from sequential_monte_carlo_tpu_torch.kernels.resample_walk import resample_gather
from sequential_monte_carlo_tpu_torch.kernels.ucsv import ucsv_propagate_reweight
from sequential_monte_carlo_tpu_torch.models.linear_gaussian import LG_UPDATES
from sequential_monte_carlo_tpu_torch.models.stochastic_volatility import SV_UPDATE
from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE
from sequential_monte_carlo_tpu_torch.ops import batched_filter as tbf
from sequential_monte_carlo_tpu_torch.ops import graphs

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

M, N, T = 6, 64, 30
ROUTES = {  # the three captured families: (model, PFConfig)
    "systematic_ucsv": ("ucsv", ("systematic", 1.0)),
    "stratified_ess_lg": ("lg", ("stratified", 0.5)),
    "apf_ucsv": ("ucsv", ("systematic", 1.0, None, "apf")),
}


def _series(t, seed=1998):
    rng = np.random.default_rng(seed)
    return (3.0 + np.cumsum(rng.normal(0, 0.3, t)) + rng.normal(0, 0.5, t)).astype(np.float32)


def _bank(kind, m, seed):
    """An m-row θ bank drawn with numpy: UC-SV (γ, x0, log σε0, log ση0) or
    LG (A, Q, R)."""
    rng = np.random.default_rng(seed)
    if kind == "ucsv":
        theta = np.c_[rng.uniform(0.1, 0.4, m), rng.normal(3.0, 0.5, m),
                      rng.normal(-1.0, 0.3, m), rng.normal(-1.0, 0.3, m)]
        return tsmc.ucsv_model(torch.tensor(theta, dtype=torch.float32))
    theta = np.c_[rng.uniform(0.3, 0.9, m), rng.uniform(0.5, 1.0, m), rng.uniform(0.5, 1.0, m)]
    return tsmc.lg_model(torch.tensor(theta, dtype=torch.float32))


def _mask(kind):
    """A live prefix, or live times with holes (mask[0] is always 1)."""
    if kind == "prefix":
        mask = (np.arange(T) < 21).astype(np.float32)
    else:
        mask = (np.random.default_rng(7).uniform(size=T) < 0.6).astype(np.float32)
        mask[0] = 1.0
    return torch.from_numpy(mask)


def _through_buffers(seed, models, y, mask, config, buffers=None):
    """The masked filter with its live steps run through the captured body
    (:meth:`graphs.StepBuffers.step`, ping-pong between the two buffers),
    as ``graphs.filter_live`` replays it on the card. Returns ((particles,
    log_w, log Z), the buffers)."""
    gen = torch.Generator().manual_seed(seed)
    init = tbf.batched_pf_init(gen, models, N, M, y[0], config)
    params = tbf.kernel_params(models, config)
    live = torch.nonzero(mask[1:] > 0).flatten() + 1
    if buffers is None:
        buffers = graphs.StepBuffers(models, params, tbf.as_cloud(init.particles),
                                     init.log_weights, y, 256)
    buffers.load(models, params, init, y, live)
    k = 0
    for _ in range(live.shape[0]):
        buffers.step(gen, config, k)
        k = 1 - k
    return buffers.result(k), buffers


def _eager(seed, models, y, mask, config):
    return tbf.batched_log_likelihood_masked(torch.Generator().manual_seed(seed), models, N, M,
                                             y, mask, config)


def _assert_equal(got, ref):
    for name, a, b in zip(("particles", "log_w", "log_z"), got, ref):
        assert a.shape == b.shape and torch.equal(a, b), name


@pytest.mark.parametrize("mask", ["prefix", "holes"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_captured_body_equals_the_eager_loop(route, mask):
    """Bitwise: the body through the buffers, from the same seed, equals
    the eager loop's particles, log-weights and log Z."""
    kind, inner = ROUTES[route]
    models, cfg = _bank(kind, M, 0), tsmc.PFConfig(*inner)
    y, live = torch.from_numpy(_series(T)), _mask(mask)
    got, buffers = _through_buffers(3, models, y, live, cfg)
    _assert_equal(got, _eager(3, models, y, live, cfg))
    # the result is a copy: the next filter overwrites the buffers
    assert all(r.data_ptr() != b.data_ptr() for r in got[:2]
               for b in buffers.clouds + buffers.log_w)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_two_banks_through_the_same_buffers(route):
    """Copy-in: a second θ bank (and another mask and series) loaded into
    the first bank's buffers equals the eager loop at that bank bit for
    bit; no step reads a tensor of the first bank."""
    kind, inner = ROUTES[route]
    cfg = tsmc.PFConfig(*inner)
    first, second = _bank(kind, M, 0), _bank(kind, M, 1)
    y1, y2 = torch.from_numpy(_series(T)), torch.from_numpy(_series(T, seed=5))
    got1, buffers = _through_buffers(3, first, y1, _mask("prefix"), cfg)
    _assert_equal(got1, _eager(3, first, y1, _mask("prefix"), cfg))
    got2, same = _through_buffers(4, second, y2, _mask("holes"), cfg, buffers)
    assert same is buffers
    _assert_equal(got2, _eager(4, second, y2, _mask("holes"), cfg))
    assert not torch.equal(got1[2], got2[2])


def _cloud(rng, m, c, n):
    return torch.tensor(rng.normal(size=(m, c, n)), dtype=torch.float32)


def test_resample_wrappers_write_out_bitwise():
    """K1 and K3's plain versions with ``out=`` write the allocating
    call's bits into the buffer and return it."""
    rng = np.random.default_rng(0)
    m, c, n = 5, 3, 96
    w = torch.tensor(rng.gamma(0.5, size=(m, n)), dtype=torch.float32)
    xs = _cloud(rng, m, c, n)
    u0 = torch.tensor(rng.uniform(size=(m, 1)), dtype=torch.float32)
    buf = torch.full_like(xs, float("nan"))
    got = resample_gather(u0, w, xs, out=buf)
    assert got is buf and torch.equal(buf, resample_gather(u0, w, xs))
    u = stratified_uniforms(torch.Generator().manual_seed(0), m, n)
    buf = torch.full_like(xs, float("nan"))
    got = resample_gather_sorted(u, w, xs, out=buf)
    assert got is buf and torch.equal(buf, resample_gather_sorted(u, w, xs))
    window = torch.full((m, c, 32), float("nan"))
    resample_gather(u0, w, xs, slot_lo=16, n_out=32, out=window)
    assert torch.equal(window, resample_gather(u0, w, xs)[..., 16:48])


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("name", ["ucsv", "lg1", "lg2", "sv"])
def test_propagate_wrapper_writes_out_bitwise(name, normalize):
    """K2's plain version with ``out=`` (new state, log-weights) writes the
    allocating call's bits, normalized or raw, with and without a carry."""
    update = {"ucsv": UCSV_UPDATE, "sv": SV_UPDATE, "lg1": LG_UPDATES[1],
              "lg2": LG_UPDATES[2]}[name]
    rng = np.random.default_rng(1)
    s = {"ucsv": 3, "sv": 1, "lg1": 1, "lg2": 2}[name]
    p = {"ucsv": 2, "sv": 3, "lg1": 4, "lg2": 11}[name]
    m, n = 4, 80
    params = torch.tensor(rng.uniform(0.2, 0.9, size=(m, p)), dtype=torch.float32)
    state = _cloud(rng, m, s, n)
    normals = _cloud(rng, update.n_normals, m, n)
    y = torch.tensor(0.3)
    carry = torch.tensor(rng.normal(size=(m, n)), dtype=torch.float32) if normalize else None
    ref = fused_elementwise_step(update, params, state, y, normals=normals, carry_logw=carry,
                                 normalize=normalize)
    out = (torch.full_like(state, float("nan")), torch.full((m, n), float("nan")))
    got = fused_elementwise_step(update, params, state, y, normals=normals, carry_logw=carry,
                                 normalize=normalize, out=out)
    assert got[0] is out[0] and got[1] is out[1] and len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("normalize", [True, False])
def test_ucsv_kernel_wrapper_writes_out_bitwise(normalize):
    """K6's plain version with ``out=`` writes the allocating call's bits,
    on the APF's strided view of the gathered cloud too."""
    rng = np.random.default_rng(2)
    m, n = 4, 80
    aug = _cloud(rng, m, 4, n)  # the cloud and the lookahead plane
    cloud = aug[:, :3]
    ge, gn = (torch.tensor(rng.uniform(0.1, 0.3, m), dtype=torch.float32) for _ in range(2))
    normals = _cloud(rng, 3, m, n)
    y = torch.tensor(2.5)
    ref = ucsv_propagate_reweight(None, y, ge, gn, cloud, normalize=normalize, normals=normals)
    out = (torch.full((m, 3, n), float("nan")), torch.full((m, n), float("nan")))
    got = ucsv_propagate_reweight(None, y, ge, gn, cloud, normalize=normalize, normals=normals,
                                  out=out)
    assert got[0] is out[0] and got[1] is out[1] and len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_out_buffers_are_checked():
    """A buffer of another shape, type or layout raises before any write."""
    rng = np.random.default_rng(3)
    m, n = 4, 64
    state, normals = _cloud(rng, m, 1, n), _cloud(rng, 1, m, n)
    params = torch.tensor(rng.uniform(0.2, 0.9, size=(m, 4)), dtype=torch.float32)
    y = torch.tensor(0.1)
    good = torch.empty(m, 1, n)
    for out in ((good, torch.empty(m, n + 1)), (good, torch.empty(m, n, dtype=torch.float64)),
                (good, torch.empty(n, m).T), (good,)):
        with pytest.raises(ValueError):
            fused_elementwise_step(LG_UPDATES[1], params, state, y, normals=normals, out=out)
    with pytest.raises(ValueError):
        resample_gather(torch.zeros(m, 1), torch.ones(m, n), state, out=torch.empty(m, 1, n - 1))


def test_launch_counter_registry():
    """Every kernel wrapper registers its launch counter once in the
    kernels' registry, which the captured graphs snapshot, restore and add
    as a whole: a difference of two snapshots added back gives the later
    one."""
    from sequential_monte_carlo_tpu_torch.kernels import _build

    registered = {(w.__name__, a) for w, a in _build.LAUNCH_COUNTERS}
    assert len(registered) == len(_build.LAUNCH_COUNTERS)
    assert registered == {("resample_gather", "launches"), ("resample_gather_sorted", "launches"),
                          ("ucsv_propagate_reweight", "launches"),
                          ("fused_elementwise_step", "instance_launches")}
    before = _build.launch_counts()
    instances = fused_elementwise_step.instance_launches
    try:
        resample_gather.launches += 3
        instances["lg1"] += 2
        after = _build.launch_counts()
        _build.set_launch_counts(before)
        assert _build.launch_counts() == before
        _build.add_launch_counts([a - b for a, b in zip(after, before)])
        assert _build.launch_counts() == after
        assert fused_elementwise_step.instance_launches is instances  # updated in place
    finally:
        _build.set_launch_counts(before)


class _Mesh:
    """Stands in for a DeviceMesh: only its presence matters here."""


def _guided():
    return tsmc.Proposal(initial=lambda mm: mm.initial_distribution(),
                         step=lambda mm, xp: mm.transition_distribution(xp))


def _mvnormal_guided():
    """A guided proposal whose step is an ``MvNormal`` (its eigh path)."""
    return tsmc.Proposal(initial=lambda mm: mm.initial_distribution(),
                         step=lambda mm, xp: tsmc.MvNormal(xp, mm.Q))


@pytest.mark.parametrize("case,captured", [
    ("systematic", True), ("residual_systematic", True), ("stratified", True),
    ("stratified_ess", True), ("systematic_ess", True), ("apf", True), ("apf_stratified", True),
    ("multinomial", True), ("residual", True), ("metropolis", True), ("guided", True),
    ("guided_mvnormal", True), ("active_n", True), ("mesh", True), ("dsl", True),
    ("cpu", False),
])
def test_captured_routes(case, captured, monkeypatch):
    """The routes the masked filter replays on the card, and the ones it
    keeps eager, by configuration alone: the gate reads no model, so a DSL
    bank (no fused kernel) takes its route too, nor the live count, which
    keys a route of its own. An ``MvNormal`` proposal is
    admitted here; its route runs its bodies eagerly by the warm-up's eigh
    rule (``tests/test_torch_route_graphs.py``). A mesh's routes replay too
    (``tests/test_torch_mesh_graphs.py``)."""
    cfg = {"systematic": tsmc.PFConfig(), "residual_systematic": tsmc.PFConfig(
        "residual_systematic"), "stratified": tsmc.PFConfig("stratified"),
        "stratified_ess": tsmc.PFConfig("stratified", 0.5),
        "systematic_ess": tsmc.PFConfig("systematic", 0.5),
        "apf": tsmc.PFConfig(algorithm="apf"),
        "apf_stratified": tsmc.PFConfig("stratified", algorithm="apf"),
        "multinomial": tsmc.PFConfig("multinomial"), "residual": tsmc.PFConfig("residual"),
        "metropolis": tsmc.PFConfig("metropolis"), "guided": tsmc.PFConfig(proposal=_guided()),
        "guided_mvnormal": tsmc.PFConfig(proposal=_mvnormal_guided()),
        "mesh": tsmc.PFConfig(mesh=_Mesh())}.get(case, tsmc.PFConfig())
    device = torch.device("cpu" if case == "cpu" else "cuda")
    active_n = 32 if case == "active_n" else None
    assert tbf.captures(cfg, active_n, device) is captured
    if case == "dsl":  # with the gate answering as on the card, the DSL filter takes a route
        models = tsmc.ssm_model(
            "ar1", params=("a",), init=lambda p: dict(x=tsmc.Normal(0.0, 1.0)),
            transition=lambda p, prev: dict(x=tsmc.Normal(p["a"] * prev["x"], 1.0)),
            observe=lambda p, s: tsmc.Normal(s["x"], 1.0))(torch.full((4, 1), 0.5))
        gate = tbf.captures
        monkeypatch.setattr(tbf, "captures", lambda config, active_n, device: gate(
            config, active_n, torch.device("cuda")))
        graphs.clear_graphs()
        tbf.batched_log_likelihood(torch.Generator().manual_seed(0), models, 16, 4,
                                   torch.from_numpy(_series(6)), cfg)
        assert [key[0] for key in graphs._cache] == ["masked"]
        graphs.clear_graphs()


def test_disable_graphs_nests_and_restores():
    """``disable_graphs`` turns every route eager inside the block, nests,
    and restores the setting before it, also on an exception."""
    models, cfg, cuda = _bank("ucsv", 4, 0), tsmc.PFConfig(), torch.device("cuda")
    assert tbf.captures(cfg, None, cuda)
    with tsmc.disable_graphs():
        assert not tbf.captures(cfg, None, cuda)
        with tsmc.disable_graphs():
            assert not tbf.captures(cfg, None, cuda)
        assert not tbf.captures(cfg, None, cuda)
    assert tbf.captures(cfg, None, cuda)
    with pytest.raises(KeyError):
        with tsmc.disable_graphs():
            raise KeyError("inside")
    assert tbf.captures(cfg, None, cuda)
    tsmc.clear_graphs()  # no CUDA: drops the (empty) cache only
    assert not graphs._cache


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_captured_body_log_z_matches_jax_in_distribution(route):
    """Distributional tier, as ``tests/test_torch_smc2.py`` holds the eager
    filter: log Z over the live prefix (30 of T=40) at one θ repeated over
    64 rows, N=256, through the captured body against the JAX package's
    ``batched_log_likelihood_masked`` on the CPU (XLA route): means within 5
    combined standard errors."""
    kind, inner = ROUTES[route]
    m, n, t = 64, 256, 40
    y = _series(t)
    mask = (np.arange(t) < 30).astype(np.float32)
    theta = np.tile(np.array([0.2, 3.0, -1.0, -1.0] if kind == "ucsv" else [0.5, 0.9, 0.8],
                             np.float32), (m, 1))
    make = {"ucsv": (tsmc.ucsv_model, jsmc.ucsv_model), "lg": (tsmc.lg_model, jsmc.lg_model)}
    models = make[kind][0](torch.from_numpy(theta))
    cfg = tsmc.PFConfig(*inner)
    gen = torch.Generator().manual_seed(11)
    init = tbf.batched_pf_init(gen, models, n, m, torch.tensor(y[0]), cfg)
    params = tbf.kernel_params(models, cfg)
    live = torch.arange(1, 30)
    buffers = graphs.StepBuffers(models, params, tbf.as_cloud(init.particles), init.log_weights,
                                 torch.from_numpy(y), 256)
    buffers.load(models, params, init, torch.from_numpy(y), live)
    for i in range(live.shape[0]):
        buffers.step(gen, cfg, i % 2)
    _, lw, lz_t = buffers.result(live.shape[0] % 2)
    jcfg = jsmc.PFConfig(inner[0], inner[1], "off",
                         algorithm=inner[3] if len(inner) > 3 else "bootstrap")
    _, _, lz_j = jax_loglik_masked(jax.random.key(11), jax.vmap(make[kind][1])(jnp.asarray(theta)),
                                   n, m, jnp.asarray(y), jnp.asarray(mask), jcfg)
    lz_j, lz_t = np.asarray(lz_j, np.float64), lz_t.double().numpy()
    assert np.all(np.isfinite(lz_t))
    np.testing.assert_allclose(torch.logsumexp(lw, 1).numpy(), 0.0, atol=1e-5)
    se = math.sqrt(lz_j.var(ddof=1) / m + lz_t.var(ddof=1) / m)
    assert abs(lz_j.mean() - lz_t.mean()) < 5 * se, (lz_j.mean(), lz_t.mean(), se)
