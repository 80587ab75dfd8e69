"""The port's sorted-grid resample + gather (the kernel that carries the
stratified inner filter) against the JAX package's three Pallas kernels of
the same contract — the walk's band route on an explicit grid and the dense
``resample_gather_bytes`` it falls back to on untileable shapes — run in TPU
interpret mode on the CPU, through the port's plain version. The CUDA kernel
itself is held against the plain version in ``test_torch_gpu.py``.

Inputs are made with numpy from a seed and handed to both packages."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sequential_monte_carlo_tpu.kernels.resample_pallas import resample_gather_bytes
from sequential_monte_carlo_tpu.kernels.resample_walk import resample_gather_walk
from sequential_monte_carlo_tpu.ops.resampling import _inverse_cdf as jax_inverse_cdf
from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
    resample_gather_sorted,
    resample_gather_sorted_plain,
    sorted_ancestors,
    stratified_uniforms,
    systematic_uniforms,
)

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)


def _inputs(seed, m, n, c, conc):
    """Weights softmax(conc · normal) (conc None: a point mass per row), a
    stratified grid u = (i + v)/n in f32, and a cloud."""
    rng = np.random.default_rng(seed)
    if conc is None:
        w = np.zeros((m, n), np.float32)
        w[np.arange(m), rng.integers(0, n, m)] = 1.0
    else:
        a = conc * rng.standard_normal((m, n))
        w = np.exp(a - a.max(-1, keepdims=True))
        w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    v = rng.random((m, n)).astype(np.float32)
    u = (np.arange(n, dtype=np.float32)[None, :] + v) / np.float32(n)
    xs = rng.standard_normal((m, c, n)).astype(np.float32)
    return u.astype(np.float32), w, xs


def _compare(u, w, xs, ref):
    """Ancestors agree with JAX's searchsorted over its f32 cumsum on all but
    < 1e-3 of slots (the port sums in f64: rounding ties move); the output is
    bitwise JAX's wherever they agree."""
    out, anc = resample_gather_sorted_plain(torch.from_numpy(u), torch.from_numpy(w),
                                            torch.from_numpy(xs))
    jax_anc = np.asarray(jax.vmap(jax_inverse_cdf)(jnp.asarray(u), jnp.asarray(w)))
    agree = anc.numpy() == jax_anc
    assert np.mean(~agree) < 1e-3
    mask = np.broadcast_to(agree[:, None, :], xs.shape)
    np.testing.assert_array_equal(out.numpy()[mask], np.asarray(ref)[mask])
    return anc.numpy()


@pytest.mark.parametrize("conc", [0.0, 2.0, 8.0, None])
def test_plain_matches_pallas_walk_band_route(conc):
    """The walk on an explicit grid (band route, tileable: M=16, N=1024)."""
    u, w, xs = _inputs(0, 16, 1024, 3, conc)
    with pltpu.force_tpu_interpret_mode():
        ref = resample_gather_walk(jnp.asarray(u), jnp.asarray(w), jnp.asarray(xs))
    anc = _compare(u, w, xs, ref)
    if conc is None:  # every slot takes the row's one particle
        np.testing.assert_array_equal(anc, np.broadcast_to(w.argmax(1)[:, None], anc.shape))


@pytest.mark.parametrize("conc", [0.0, 2.0, 8.0, None])
def test_plain_matches_pallas_bytes_untileable(conc):
    """The dense byte-plane kernel at a shape the walk cannot tile (M=3,
    N=384), directly and through the walk's fallback."""
    u, w, xs = _inputs(1, 3, 384, 2, conc)
    with pltpu.force_tpu_interpret_mode():
        ref = resample_gather_bytes(jnp.asarray(u), jnp.asarray(w), jnp.asarray(xs))
        ref_walk = resample_gather_walk(jnp.asarray(u), jnp.asarray(w), jnp.asarray(xs))
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(ref_walk))
    _compare(u, w, xs, ref)


def test_edges_of_the_contract():
    """u == 0 lands in bucket 0 (searchsorted-left); a u just below 1 over a
    row whose tail has zero weight takes the last particle of nonzero
    weight, never a slot past N; the last cdf entry is 1 + 1e-6."""
    n = 8
    w = torch.tensor([[0.0, 0.5, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0]])
    u = torch.tensor([[0.0, 0.1, 0.25, 0.5, 0.6, 0.75, 0.9, 1.0 - 2**-24]])
    anc = sorted_ancestors(u, w)
    assert anc.tolist() == [[0, 1, 1, 1, 2, 2, 2, 2]]
    w = torch.zeros((1, n))
    w[0, -1] = 1e-30  # all mass in the last slot
    assert sorted_ancestors(u, w).tolist() == [[0] + [n - 1] * (n - 1)]


def test_wrapper_checks_and_cpu_route():
    """The wrapper checks its inputs, and on CPU tensors runs the plain
    version without counting a kernel launch. A grid shorter than the row is
    a window of slots (particle-axis sharding); one longer than the row, or
    of other rows, is refused."""
    u, w, xs = (torch.from_numpy(a) for a in _inputs(2, 8, 256, 3, 1.0))
    before = resample_gather_sorted.launches
    got, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
    assert resample_gather_sorted.launches == before
    ref, anc_ref = resample_gather_sorted_plain(u, w, xs)
    assert torch.equal(got, ref) and torch.equal(anc, anc_ref) and anc.dtype == torch.int32
    with pytest.raises(TypeError):
        resample_gather_sorted(u.double(), w, xs)
    assert torch.equal(resample_gather_sorted(u[:, 128:].contiguous(), w, xs), got[:, :, 128:])
    with pytest.raises(ValueError):
        resample_gather_sorted(torch.cat([u, u], 1), w, xs)
    with pytest.raises(ValueError):
        resample_gather_sorted(u[:1].contiguous(), w, xs)
    with pytest.raises(ValueError):
        resample_gather_sorted(u.T.contiguous().T, w, xs)


@pytest.mark.parametrize("grid", [systematic_uniforms, stratified_uniforms])
def test_uniform_grids(grid):
    """Sorted grids in [0, 1), one uniform per stratum [i/n, (i+1)/n)."""
    m, n = 16, 512
    u = grid(torch.Generator().manual_seed(3), m, n)
    assert u.shape == (m, n) and u.dtype == torch.float32
    assert bool(torch.all(u[:, 1:] >= u[:, :-1])) and bool(torch.all((u >= 0) & (u < 1)))
    assert torch.equal(torch.floor(u * n), torch.arange(n, dtype=torch.float32).expand(m, n))
    if grid is systematic_uniforms:  # one offset per row
        offsets = u * n - torch.arange(n)
        torch.testing.assert_close(offsets, offsets[:, :1].expand(m, n), rtol=0, atol=1e-3)
