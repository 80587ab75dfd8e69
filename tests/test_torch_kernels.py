"""The PyTorch port's two inner-step kernels against the JAX package's
Pallas kernels (run in TPU interpret mode on the CPU, as the JAX tests run
them), through the port's plain versions. The CUDA and Triton kernels
themselves are held against the plain versions in ``test_torch_gpu.py``.

Inputs are made with numpy from a seed and handed to both packages."""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sequential_monte_carlo_tpu.kernels.propagate_pallas import fused_elementwise_step as jax_fused_step
from sequential_monte_carlo_tpu.kernels.resample_walk import count_ancestors as jax_count_ancestors
from sequential_monte_carlo_tpu.kernels.resample_walk import resample_gather_walk
from sequential_monte_carlo_tpu.models.ucsv import _ucsv_update
from sequential_monte_carlo_tpu_torch.kernels.propagate import (
    _launch_config,
    fused_elementwise_step,
    fused_elementwise_step_plain,
)
from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
    count_ancestors,
    resample_gather,
    resample_gather_plain,
)
from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE

# One intra-op thread: with torch's OpenMP workers in a process that also runs
# the JAX package, plain-path results came out of some runs with ~1e-4
# relative error on the rows of one worker's chunk (root cause not found;
# ROADMAP Queue 3). The tests are small, so nothing is lost.
torch.set_num_threads(1)


def _weights(rng, m, n, conc):
    """Row-normalized weights, softmax(conc · normal), as f32."""
    a = conc * rng.standard_normal((m, n))
    w = np.exp(a - a.max(-1, keepdims=True))
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _resample_inputs(seed, m, n, c, conc):
    rng = np.random.default_rng(seed)
    w = _weights(rng, m, n, conc)
    xs = rng.standard_normal((m, c, n)).astype(np.float32)
    u0 = rng.random((m, 1)).astype(np.float32)
    return u0, w, xs


@pytest.mark.parametrize("conc", [0.0, 2.0, 8.0])
def test_count_ancestors_match_jax(conc):
    """Same ⌈N·cdf − u0⌉ count definition; a different cumsum order can move
    an f32 rounding tie, so allow < 1e-3 of slots to differ."""
    u0, w, _ = _resample_inputs(0, 32, 2048, 1, conc)
    ours = count_ancestors(torch.from_numpy(u0), torch.from_numpy(w)).numpy()
    ref = np.asarray(jax_count_ancestors(jnp.asarray(u0), jnp.asarray(w)))
    assert ours.dtype == np.int32
    assert np.mean(ours != ref) < 1e-3


@pytest.mark.parametrize("c", [3, 4])
def test_resample_gather_plain_matches_pallas_walk(c):
    """Plain kernel 1 against the Pallas count-route walk (interpret mode)
    at M=16, N=1024: bitwise wherever the ancestors agree (all but < 1e-3
    of slots)."""
    u0, w, xs = _resample_inputs(1, 16, 1024, c, 2.0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(resample_gather_walk(None, jnp.asarray(w), jnp.asarray(xs),
                                              u0=jnp.asarray(u0)))
    out, anc = resample_gather_plain(torch.from_numpy(u0), torch.from_numpy(w),
                                     torch.from_numpy(xs))
    jax_anc = np.asarray(jax_count_ancestors(jnp.asarray(u0), jnp.asarray(w)))
    agree = anc.numpy() == jax_anc
    assert np.mean(~agree) < 1e-3
    mask = np.broadcast_to(agree[:, None, :], xs.shape)
    np.testing.assert_array_equal(out.numpy()[mask], ref[mask])


def _edge_case(case):
    """(u0, w, xs) of an edge case of the count formula, at M=8: a point mass
    at the first or the last slot, long runs of zero weight, N=1, N=1000."""
    rng = np.random.default_rng(6)
    m, n, c = 8, {"n1": 1, "n1000": 1000}.get(case, 1024), 3
    if case == "point_first":
        w = np.zeros((m, n), np.float32)
        w[:, 0] = 1.0
    elif case == "point_last":
        w = np.zeros((m, n), np.float32)
        w[:, -1] = 1.0
    elif case == "zero_runs":
        w = rng.random((m, n)).astype(np.float32)
        w[:, (np.arange(n) // 97) % 3 != 0] = 0.0  # runs of 194 zeros between runs of 97
    else:
        w = _weights(rng, m, n, 2.0)
    xs = rng.standard_normal((m, c, n)).astype(np.float32)
    u0 = rng.random((m, 1)).astype(np.float32)
    u0[0] = 0.0  # the offset's edge
    return u0, w, xs


EDGE_CASES = ["point_first", "point_last", "zero_runs", "n1", "n1000"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_count_ancestors_edge_cases_match_jax(case):
    """The oracle the kernel is held to, on the cases its span fill must
    survive, against the JAX package's count definition: equal ancestors
    (a point mass and N=1 exactly; elsewhere all but < 1e-3 of slots, the
    f32 cumsum's rounding ties), sorted, and none on a zero weight."""
    u0, w, _ = _edge_case(case)
    ours = count_ancestors(torch.from_numpy(u0), torch.from_numpy(w)).numpy()
    ref = np.asarray(jax_count_ancestors(jnp.asarray(u0), jnp.asarray(w)))
    if case in ("point_first", "point_last", "n1"):
        np.testing.assert_array_equal(ours, ref)
        hot = {"point_first": 0, "point_last": w.shape[1] - 1, "n1": 0}[case]
        assert np.all(ours == hot)
    else:
        assert np.mean(ours != ref) < 1e-3
    assert np.all(np.diff(ours, axis=1) >= 0)
    assert np.all(w[np.arange(w.shape[0])[:, None], ours] > 0)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_resample_gather_plain_edge_cases_match_pallas_walk(case):
    """Plain kernel 1 against the Pallas walk with u0 (interpret mode) on the
    edge cases. Where the walk takes its count route (N a multiple of 128):
    bitwise wherever the ancestors agree with the JAX count definition's
    (all but < 1e-3 of slots). N=1 and N=1000 are shapes the walk cannot
    tile: its dense fallback searches the grid u = (i + u0)/N, which breaks
    f32 ties the other way, so all but < 1e-3 of outputs are equal."""
    u0, w, xs = _edge_case(case)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(resample_gather_walk(None, jnp.asarray(w), jnp.asarray(xs),
                                              u0=jnp.asarray(u0)))
    out, anc = resample_gather_plain(torch.from_numpy(u0), torch.from_numpy(w),
                                     torch.from_numpy(xs))
    if w.shape[1] % 128:
        assert np.mean(out.numpy() != ref) < 1e-3
        return
    jax_anc = np.asarray(jax_count_ancestors(jnp.asarray(u0), jnp.asarray(w)))
    agree = anc.numpy() == jax_anc
    assert np.mean(~agree) < 1e-3
    mask = np.broadcast_to(agree[:, None, :], xs.shape)
    np.testing.assert_array_equal(out.numpy()[mask], ref[mask])


def test_resample_gather_point_mass_and_counts():
    """A point mass makes every ancestor that particle; offspring counts
    always sum to N and ancestors are sorted."""
    m, n, c = 4, 1024, 3
    rng = np.random.default_rng(2)
    w = np.zeros((m, n), np.float32)
    hot = rng.integers(0, n, m)
    w[np.arange(m), hot] = 1.0
    xs = torch.from_numpy(rng.standard_normal((m, c, n)).astype(np.float32))
    u0 = torch.from_numpy(rng.random((m, 1)).astype(np.float32))
    out, anc = resample_gather(u0, torch.from_numpy(w), xs, return_ancestors=True)
    assert torch.equal(anc, torch.from_numpy(hot.astype(np.int32))[:, None].expand(m, n))
    assert torch.equal(out, xs[torch.arange(m), :, hot][:, :, None].expand(m, c, n))
    u0, w2, xs2 = _resample_inputs(3, m, n, c, 4.0)
    _, anc = resample_gather(torch.from_numpy(u0), torch.from_numpy(w2),
                             torch.from_numpy(xs2), return_ancestors=True)
    counts = torch.zeros((m, n)).scatter_add_(1, anc.long(), torch.ones((m, n)))
    assert torch.all(counts.sum(1) == n)
    assert torch.all(anc[:, 1:] >= anc[:, :-1])


def test_resample_gather_checks_and_cpu_route():
    """The wrapper checks its inputs, and on CPU tensors runs the plain
    version without counting a kernel launch."""
    u0, w, xs = (torch.from_numpy(a) for a in _resample_inputs(4, 8, 256, 3, 1.0))
    before = resample_gather.launches
    got = resample_gather(u0, w, xs)
    assert resample_gather.launches == before
    assert torch.equal(got, resample_gather_plain(u0, w, xs)[0])
    with pytest.raises(TypeError):
        resample_gather(u0, w.double(), xs)
    with pytest.raises(ValueError):
        resample_gather(u0[:4], w, xs)
    with pytest.raises(ValueError):
        resample_gather(u0, w, xs.transpose(1, 2).contiguous().transpose(1, 2))


def _jax_update_injected(par, y, state, normals):
    """JAX UC-SV update reading its normals from three pass-through state
    planes (interpret mode's in-kernel PRNG is a stub)."""
    new, logw = _ucsv_update(par, y, state[:3], state[3:])
    return tuple(new) + tuple(state[3:]), logw


def _propagate_inputs(seed, m, n):
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((m, 3, n)).astype(np.float32)
    state[:, 1:] *= 0.5
    normals = rng.standard_normal((3, m, n)).astype(np.float32)
    params = np.stack([rng.uniform(0.05, 0.5, m), rng.uniform(0.05, 0.5, m)],
                      1).astype(np.float32)
    return params, state, normals


def test_fused_step_plain_matches_pallas_builder():
    """Plain kernel 2 against the Pallas builder instanced with the UC-SV
    update and normalize=True (interpret mode), fed the same normals:
    planes, log_norm, lse and ess to rtol 1e-5 (f32 rounding of exp/log in
    another order). The port runs first and its results are copied out:
    tensors allocated while the interpret-mode kernel runs can be written
    by it."""
    m, n, y = 16, 1024, 1.3
    params, state, normals = _propagate_inputs(5, m, n)
    ours = [t.numpy().copy() for t in fused_elementwise_step(
        UCSV_UPDATE, torch.from_numpy(params), torch.from_numpy(state),
        torch.tensor(y), normals=torch.from_numpy(normals))]
    planes = tuple(jnp.asarray(state[:, s]) for s in range(3))
    planes += tuple(jnp.asarray(z) for z in normals)
    with pltpu.force_tpu_interpret_mode():
        new_j, log_norm_j, lse_j, ess_j = jax.block_until_ready(jax_fused_step(
            _jax_update_injected, 0, y, (jnp.asarray(params[:, 0]), jnp.asarray(params[:, 1])),
            planes, n_normals=3, normalize=True))
    ref = [np.stack([np.asarray(p) for p in new_j[:3]], 1), np.asarray(log_norm_j),
           np.asarray(lse_j), np.asarray(ess_j)]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_fused_step_cpu_route_needs_normals():
    params, state, normals = (torch.from_numpy(a) for a in _propagate_inputs(6, 4, 64))
    y = torch.tensor(0.5)
    with pytest.raises(ValueError):
        fused_elementwise_step(UCSV_UPDATE, params, state, y,
                               seed=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        fused_elementwise_step(UCSV_UPDATE, params, state, y, normals=normals[:2])
    before = sum(fused_elementwise_step.instance_launches.values())
    out = fused_elementwise_step(UCSV_UPDATE, params, state, y, normals=normals)
    assert sum(fused_elementwise_step.instance_launches.values()) == before
    ref = fused_elementwise_step_plain(UCSV_UPDATE, params, state, y, normals)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n, normalize, launch", [
    (100, True, (128, 128, 1, 1, False)), (1024, True, (1024, 1024, 1, 8, False)),
    (8192, True, (1024, 8192, 1, 8, True)), (16384, True, (1024, 8192, 1, 8, True)),
    (100, False, (128, 128, 1, 1, False)), (1024, False, (1024, 1024, 1, 8, False)),
    (8192, False, (1024, 8192, 8, 8, False)), (65536, False, (1024, 8192, 64, 8, False)),
    (16385, True, (1024, 8192, 5, 8, True)), (40000, True, (1024, 8192, 10, 8, True)),
    (65536, True, (1024, 8192, 16, 8, True))])
def test_k2_launch_is_a_function_of_the_row_length(n, normalize, launch):
    """Kernel 2's launch (BLOCK, BLOCK2, programs a row, warps, LOOP) is a
    function of the row length alone, never of the rows or the model: rows
    of up to 16,384 keep the launch they had before the split route (the
    SMC² benchmark's normalized rows of 8,192 among them), and longer
    normalized rows take the split route, ⌈n / 4096⌉ programs a row."""
    assert tuple(inspect.signature(_launch_config).parameters) == ("n", "normalize")
    assert _launch_config(n, normalize) == launch

