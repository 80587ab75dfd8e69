"""The port's hand-written UC-SV propagate + reweight (the auxiliary
filter's second stage on UC-SV), kernel 2's route without the normalize,
the distributions' means and UC-SV's transition against the JAX package,
on the same inputs made with numpy from a seed. The Pallas kernels run in
TPU interpret mode, whose in-kernel PRNG is a stub: the UC-SV kernel then
draws constant normals, which are recovered from its state deltas and fed
to the port's plain version; the builder reads injected normals from
pass-through planes. The CUDA kernel itself is held against its plain
version in ``test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import sequential_monte_carlo_tpu as jsmc
from sequential_monte_carlo_tpu.kernels.propagate_pallas import fused_elementwise_step as jax_fused_step
from sequential_monte_carlo_tpu.kernels.ucsv_pallas import ucsv_propagate_reweight as jax_ucsv_kernel
from sequential_monte_carlo_tpu.models.linear_gaussian import _lg_update as jax_lg_update
from sequential_monte_carlo_tpu.models.stochastic_volatility import _sv_update as jax_sv_update
from sequential_monte_carlo_tpu.models.ucsv import _ucsv_update as jax_ucsv_update
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.kernels import resample_sorted
from sequential_monte_carlo_tpu_torch.kernels.propagate import (
    fused_elementwise_step,
    fused_elementwise_step_plain,
)
from sequential_monte_carlo_tpu_torch.kernels.ucsv import (
    ucsv_propagate_reweight,
    ucsv_propagate_reweight_plain,
)
from sequential_monte_carlo_tpu_torch.models.linear_gaussian import LG_UPDATES
from sequential_monte_carlo_tpu_torch.models.stochastic_volatility import SV_UPDATE
from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

# f32 elementwise math (exp, log) in another library: a few ulps
TOL = dict(rtol=1e-5, atol=1e-5)


def _ucsv_inputs(seed, m, n):
    rng = np.random.default_rng(seed)
    cloud = (0.5 * rng.standard_normal((m, 3, n))).astype(np.float32)
    ge = rng.uniform(0.05, 0.5, m).astype(np.float32)
    gn = rng.uniform(0.05, 0.5, m).astype(np.float32)
    return cloud, ge, gn


@pytest.mark.parametrize("normalize", [False, True])
def test_plain_matches_pallas_ucsv_kernel(normalize):
    """The plain version ≡ ``ucsv_pallas.ucsv_propagate_reweight`` (interpret
    mode), fed the normals recovered from the JAX kernel's state deltas
    (γ ≠ 0): planes, logw (or log_norm, lse, ess) to rtol 1e-5."""
    m, n, y = 8, 256, 1.3
    cloud, ge, gn = _ucsv_inputs(0, m, n)
    with pltpu.force_tpu_interpret_mode():
        out_j = [np.asarray(a) for a in jax.block_until_ready(jax_ucsv_kernel(
            3, y, jnp.asarray(ge), jnp.asarray(gn), *map(jnp.asarray, cloud.transpose(1, 0, 2)),
            normalize=normalize))]
    z = np.stack([(out_j[0] - cloud[:, 0]) / np.exp(0.5 * cloud[:, 1]),
                  (out_j[1] - cloud[:, 1]) / ge[:, None],
                  (out_j[2] - cloud[:, 2]) / gn[:, None]]).astype(np.float32)
    ours = ucsv_propagate_reweight(None, torch.tensor(y), torch.from_numpy(ge),
                                   torch.from_numpy(gn), torch.from_numpy(cloud),
                                   normalize=normalize, normals=torch.from_numpy(z))
    np.testing.assert_allclose(ours[0].numpy(), np.stack(out_j[:3], 1), **TOL)
    for got, want in zip(ours[1:], out_j[3:]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_plain_matches_kernel2_ucsv_instance(normalize):
    """On random normals, the plain version ≡ kernel 2's UC-SV plain version
    (which the Pallas builder holds): the two routes compute one function."""
    m, n = 8, 300
    cloud, ge, gn = map(torch.from_numpy, _ucsv_inputs(1, m, n))
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((3, m, n)).astype(np.float32))
    y = torch.tensor(0.4)
    ours = ucsv_propagate_reweight_plain(y, ge, gn, cloud, z, normalize)
    ref = fused_elementwise_step_plain(UCSV_UPDATE, torch.stack([ge, gn], 1), cloud, y, z,
                                       normalize=normalize)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_zero_gamma_freezes_the_vols():
    """γ = 0 leaves log σε and log ση bitwise unchanged, in the plain version
    and in the JAX kernel alike."""
    m, n = 8, 256
    cloud, _, _ = _ucsv_inputs(3, m, n)
    zero = np.zeros(m, np.float32)
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((3, m, n)).astype(np.float32))
    new, _ = ucsv_propagate_reweight(None, torch.tensor(0.2), torch.from_numpy(zero),
                                     torch.from_numpy(zero), torch.from_numpy(cloud), normals=z)
    assert torch.equal(new[:, 1:], torch.from_numpy(cloud[:, 1:]))
    with pltpu.force_tpu_interpret_mode():
        out_j = jax_ucsv_kernel(5, 0.2, jnp.asarray(zero), jnp.asarray(zero),
                                *map(jnp.asarray, cloud.transpose(1, 0, 2)))
    np.testing.assert_array_equal(np.asarray(out_j[1]), cloud[:, 1])
    np.testing.assert_array_equal(np.asarray(out_j[2]), cloud[:, 2])


def test_wrapper_checks_and_cpu_route():
    """The wrapper takes a strided view of a wider cloud (the auxiliary
    filter's split-off planes) and γ of any stride, needs injected normals
    on the CPU, counts no launch there, and refuses wrong shapes and types."""
    m, n = 6, 128
    cloud, ge, gn = map(torch.from_numpy, _ucsv_inputs(5, m, n))
    wide = torch.cat([cloud, torch.zeros((m, 1, n))], dim=1)
    z = torch.randn((3, m, n), generator=torch.Generator().manual_seed(0))
    y = torch.tensor(0.3)
    gam = torch.stack([ge, gn], 1)  # columns of stride 2, as the model passes them
    before = ucsv_propagate_reweight.launches
    got = ucsv_propagate_reweight(None, y, gam[:, 0], gam[:, 1], wide[:, :3], normals=z,
                                  normalize=True)
    assert ucsv_propagate_reweight.launches == before
    ref = ucsv_propagate_reweight_plain(y, ge, gn, cloud, z, normalize=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[2].shape == (m, 1) and got[3].shape == (m, 1)
    with pytest.raises(ValueError, match="normals"):
        ucsv_propagate_reweight(torch.zeros(1, dtype=torch.int64), y, ge, gn, cloud)
    with pytest.raises(ValueError):
        ucsv_propagate_reweight(None, y, ge, gn, cloud[:, :2], normals=z)
    with pytest.raises(ValueError):
        ucsv_propagate_reweight(None, y, ge[:3], gn, cloud, normals=z)
    with pytest.raises(TypeError):
        ucsv_propagate_reweight(None, y, ge, gn, cloud.double(), normals=z)
    with pytest.raises(ValueError):
        ucsv_propagate_reweight(None, y, ge, gn, cloud.transpose(1, 2).contiguous().transpose(1, 2),
                                normals=z)


def _jax_injected(update, n_state):
    """A JAX update reading its normals from pass-through state planes
    (interpret mode's in-kernel PRNG is a stub)."""
    def f(par, y, state, normals):
        new, logw = update(par, y, state[:n_state], state[n_state:])
        return tuple(new) + tuple(state[n_state:]), logw
    return f


@pytest.mark.parametrize("name", ["ucsv", "lg1", "lg2", "sv"])
def test_raw_route_plain_matches_pallas_builder(name):
    """Kernel 2's route without the normalize, per instance, against the
    Pallas builder with ``normalize=False`` (interpret mode) fed the same
    normals: planes and raw log-weights to rtol 1e-5; the route takes a
    strided view of a wider cloud and refuses carried log-weights, as the
    builder does."""
    rng = np.random.default_rng(6)
    m, n, y = 16, 512, 0.6
    upd, jupd, p = {"lg1": (LG_UPDATES[1], jax_lg_update(1), 4),
                    "lg2": (LG_UPDATES[2], jax_lg_update(2), 11),
                    "sv": (SV_UPDATE, jax_sv_update, 3),
                    "ucsv": (UCSV_UPDATE, jax_ucsv_update, 2)}[name]
    s = 3 if name == "ucsv" else upd.n_normals
    params = rng.uniform(0.1, 0.9, (m, p)).astype(np.float32)
    wide = (0.5 * rng.standard_normal((m, s + 1, n))).astype(np.float32)
    state = wide[:, :s]
    normals = rng.standard_normal((upd.n_normals, m, n)).astype(np.float32)
    ours = [t.numpy().copy() for t in fused_elementwise_step(
        upd, torch.from_numpy(params), torch.from_numpy(wide)[:, :s], torch.tensor(y),
        normals=torch.from_numpy(normals), normalize=False)]
    assert len(ours) == 2
    planes = tuple(jnp.asarray(state[:, i]) for i in range(s))
    planes += tuple(jnp.asarray(z) for z in normals)
    with pltpu.force_tpu_interpret_mode():
        new_j, logw_j = jax.block_until_ready(jax_fused_step(
            _jax_injected(jupd, s), 0, y, tuple(jnp.asarray(params[:, i]) for i in range(p)),
            planes, n_normals=upd.n_normals, normalize=False))
    np.testing.assert_allclose(ours[0], np.stack([np.asarray(q) for q in new_j[:s]], 1), **TOL)
    np.testing.assert_allclose(ours[1], np.asarray(logw_j), **TOL)
    with pytest.raises(ValueError, match="normalize"):
        fused_elementwise_step(upd, torch.from_numpy(params), torch.from_numpy(state.copy()),
                               torch.tensor(y), normals=torch.from_numpy(normals),
                               carry_logw=torch.zeros((m, n)), normalize=False)


def test_models_route_the_raw_step():
    """``fused_propagate_reweight(normalize=False)``: UC-SV goes to the
    UC-SV kernel's wrapper, LG and SV to kernel 2's raw route; both return
    (new cloud, logw) equal to their plain versions."""
    m, n = 4, 64
    rng = np.random.default_rng(7)
    y = torch.tensor(0.5)
    ucsv = tsmc.ucsv_model(torch.tensor([0.2, 3.0, 0.2, 0.3]).expand(m, 4))
    cloud = torch.from_numpy((0.5 * rng.standard_normal((m, 3, n))).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((3, m, n)).astype(np.float32))
    got = ucsv.fused_propagate_reweight(y, cloud, normals=z, normalize=False)
    ge = torch.full((m,), 0.2)
    for a, b in zip(got, ucsv_propagate_reweight_plain(y, ge, ge, cloud, z)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="normalize"):
        ucsv.fused_propagate_reweight(y, cloud, normals=z, normalize=False,
                                      carry_logw=torch.zeros((m, n)))
    lg = tsmc.lg_model(torch.tensor([0.5, 0.9, 0.8]).expand(m, 3))
    got = lg.fused_propagate_reweight(y, cloud[:, :1], normals=z[:1], normalize=False)
    ref = fused_elementwise_step_plain(LG_UPDATES[1], lg.fused_params(), cloud[:, :1], y, z[:1],
                                       normalize=False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _dist_pairs(rng):
    f = lambda *s: rng.uniform(0.2, 1.5, s).astype(np.float32)  # noqa: E731
    loc, scale = rng.normal(size=5).astype(np.float32), f(5)
    lo, hi = (loc - f(5)).astype(np.float32), (loc + f(5)).astype(np.float32)
    a = rng.normal(size=(5, 3, 3)).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1) + np.eye(3)).astype(np.float32)
    mean = rng.normal(size=(5, 3)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    return {
        "normal": (tsmc.Normal(T(loc), T(scale)), jsmc.Normal(J(loc), J(scale))),
        "lognormal": (tsmc.LogNormal(T(loc), T(scale)), jsmc.LogNormal(J(loc), J(scale))),
        "uniform": (tsmc.Uniform(T(lo), T(hi)), jsmc.Uniform(J(lo), J(hi))),
        "truncated_normal": (tsmc.TruncatedNormal(T(loc), T(scale), T(lo), T(hi)),
                             jsmc.TruncatedNormal(J(loc), J(scale), J(lo), J(hi))),
        "truncated_normal_half_open": (
            tsmc.TruncatedNormal(T(loc), T(scale), T(lo), torch.full((5,), float("inf"))),
            jsmc.TruncatedNormal(J(loc), J(scale), J(lo), jnp.full((5,), jnp.inf))),
        "product": (tsmc.Product(tsmc.Normal(T(loc), T(scale))),
                    jsmc.Product(jsmc.Normal(J(loc), J(scale)))),
        "tuple_product": (
            tsmc.TupleProduct((tsmc.Normal(T(loc), T(scale)), tsmc.Uniform(T(lo), T(hi)),
                               tsmc.LogNormal(torch.tensor(0.0), torch.tensor(1.0)))),
            jsmc.TupleProduct((jsmc.Normal(J(loc), J(scale)), jsmc.Uniform(J(lo), J(hi)),
                               jsmc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0))))),
        "mvnormal": (tsmc.MvNormal(T(mean), T(cov)), jsmc.MvNormal(J(mean), J(cov))),
    }


@pytest.mark.parametrize("kind", ["normal", "lognormal", "uniform", "truncated_normal",
                                  "truncated_normal_half_open", "product", "tuple_product",
                                  "mvnormal"])
def test_distribution_means_match_jax(kind):
    """``mean()`` (and ``variance()`` where the JAX package has it) to rtol
    1e-5, with the JAX result's shape."""
    ours, ref = _dist_pairs(np.random.default_rng(8))[kind]
    for method in ("mean", "variance"):
        if not hasattr(ref, method):
            assert not hasattr(ours, method)
            continue
        want = np.asarray(getattr(ref, method)())
        got = getattr(ours, method)().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_ucsv_transition_distribution_matches_jax():
    """UC-SV's transition at states (N, M, 3) against the JAX model vmapped
    over M: log-density of the next states and the mean, which is the state."""
    rng = np.random.default_rng(9)
    m = 5
    theta = np.stack([rng.uniform(0.05, 0.5, m), rng.normal(3, 1, m), rng.uniform(0, 1, m),
                      rng.uniform(0, 1, m)], 1).astype(np.float32)
    ours = tsmc.ucsv_model(torch.from_numpy(theta))
    ref = jax.vmap(jsmc.ucsv_model)(jnp.asarray(theta))
    x = (0.5 * rng.standard_normal((7, m, 3))).astype(np.float32)
    xn = (0.5 * rng.standard_normal((7, m, 3))).astype(np.float32)
    d = ours.transition_distribution(torch.from_numpy(x))
    np.testing.assert_allclose(
        d.log_prob(torch.from_numpy(xn)).numpy(),
        np.asarray(jax.vmap(lambda md, s, sn: md.transition_distribution(s).log_prob(sn),
                            in_axes=(0, 1, 1), out_axes=1)(ref, jnp.asarray(x), jnp.asarray(xn))),
        **TOL)
    assert torch.equal(d.mean(), torch.from_numpy(x))


class _MetaGenerator:
    """Stands in for a generator on another device than the CPU."""

    device = torch.device("meta")


@pytest.mark.parametrize("grid", ["systematic_uniforms", "stratified_uniforms"])
def test_uniform_grids_draw_on_the_generators_device(monkeypatch, grid):
    """With no device given, the grids are drawn on the generator's device
    (a CUDA generator draws on the card), not on the CPU."""
    gen = _MetaGenerator()
    seen = []

    def rand(shape, generator=None, device=None):
        assert generator is gen
        seen.append(torch.device(device))
        return torch.empty(shape, device=device)

    monkeypatch.setattr(resample_sorted.torch, "rand", rand)
    u = getattr(resample_sorted, grid)(gen, 4, 16)
    assert seen == [torch.device("meta")] and u.device.type == "meta" and u.shape == (4, 16)
