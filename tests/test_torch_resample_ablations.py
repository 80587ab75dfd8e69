"""The JAX package's last resample kernels — the ablations K7
(``benchmarks/ablations/resample_take_walk.py::resample_gather_take``), K8
(``benchmarks/ablations/resample_banded.py::resample_gather_banded``, both
branches of its ``lax.cond``) and the prototypes K9
(``benchmarks/proto_walk4.py::resample_gather_walk4/5/6/7``) — compute the
sorted-grid kernel's function: searchsorted-left over cdf = cumsum(w)/sum(w)
with cdf[N−1] = 1 + 1e-6, then a take. The port carries them all by that
kernel (``kernels/resample_sorted.py``), so its plain version is held here
against each of them, run in TPU interpret mode on the CPU at M=8, N=2048
(every one of them runs in interpret mode). v7 builds its grid
u = (i + u0)/N inside the kernel; the port is handed the same grid, built in
f32. The CUDA kernel itself is held against the plain version in
``test_torch_gpu.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from benchmarks import proto_walk4
from benchmarks.ablations.resample_banded import resample_gather_banded
from benchmarks.ablations.resample_take_walk import resample_gather_take
from sequential_monte_carlo_tpu.ops.resampling import _inverse_cdf as jax_inverse_cdf
from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import resample_gather_sorted_plain

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

M, N, C = 8, 2048, 3

KERNELS = {
    "take_tm2": lambda u, u0, w, xs: resample_gather_take(u, w, xs, tm=2),
    "banded": lambda u, u0, w, xs: resample_gather_banded(u, w, xs),
    "walk4": lambda u, u0, w, xs: proto_walk4.resample_gather_walk4(u, w, xs),
    "walk5": lambda u, u0, w, xs: proto_walk4.resample_gather_walk5(u, w, xs),
    "walk6": lambda u, u0, w, xs: proto_walk4.resample_gather_walk6(u, w, xs),
    "walk7": lambda u, u0, w, xs: proto_walk4.resample_gather_walk7(u0, w, xs),
}


def _inputs(profile):
    """Weights (flat, softmax(2·normal), or a point mass at a random slot
    per row), offsets u0, the systematic grid u = (i + u0)/N in f32, and a
    cloud, made with numpy from a seed."""
    rng = np.random.default_rng(21)
    if profile == "flat":
        w = np.ones((M, N), np.float32)
    elif profile == "skewed":
        a = 2.0 * rng.standard_normal((M, N))
        w = np.exp(a - a.max(-1, keepdims=True))
        w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    else:
        w = np.zeros((M, N), np.float32)
        w[np.arange(M), rng.integers(0, N, M)] = 1.0
    u0 = rng.random((M, 1)).astype(np.float32)
    u = ((np.arange(N, dtype=np.float32)[None, :] + u0) / np.float32(N)).astype(np.float32)
    xs = rng.standard_normal((M, C, N)).astype(np.float32)
    return w, u0, u, xs


def _banded_window_fits(u, w, tm=8, ot=256, win=512):
    """The predicate of K8's ``lax.cond`` at its default tiling (True: the
    banded kernel runs; False: the dense fallback)."""
    cdf = jnp.cumsum(jnp.asarray(w), axis=-1)
    cdf = (cdf / cdf[..., -1:]).at[..., -1].set(jnp.float32(1.0) + 1e-6)
    search = jax.vmap(lambda c, q: jnp.searchsorted(c, q, side="left"))
    a_start = jnp.clip(search(cdf, jnp.asarray(u[:, ::ot])), 0, N - 1)
    a_end = jnp.clip(search(cdf, jnp.asarray(u[:, ot - 1::ot])), 0, N - 1)
    grp_start = a_start.reshape(M // tm, tm, -1).min(axis=1)
    grp_end = a_end.reshape(M // tm, tm, -1).max(axis=1)
    jblk = grp_start // win
    hi_block = jnp.minimum(jblk + 1, N // win - 1)
    return bool(jnp.all(grp_end < (hi_block + 1) * win))


@pytest.mark.parametrize("profile", ["flat", "skewed", "point"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_sorted_plain_matches_ablation_kernel(kernel, profile):
    """Ancestors of the port's plain version agree with the JAX
    searchsorted over its f32 cumsum on all but < 1e-3 of slots (the port
    sums in f64: rounding ties move), and its output is bitwise the
    kernel's wherever they agree; the kernel itself is bitwise that
    searchsorted + take."""
    w, u0, u, xs = _inputs(profile)
    out, anc = resample_gather_sorted_plain(torch.from_numpy(u), torch.from_numpy(w),
                                            torch.from_numpy(xs))
    out, anc = out.numpy().copy(), anc.numpy().copy()  # before the interpret-mode kernel
    with pltpu.force_tpu_interpret_mode():
        got = np.asarray(jax.block_until_ready(KERNELS[kernel](
            jnp.asarray(u), jnp.asarray(u0), jnp.asarray(w), jnp.asarray(xs))))
    jax_anc = np.asarray(jax.vmap(jax_inverse_cdf)(jnp.asarray(u), jnp.asarray(w)))
    np.testing.assert_array_equal(got, np.take_along_axis(xs, jax_anc[:, None, :], 2))
    agree = anc == jax_anc
    assert np.mean(~agree) < 1e-3
    mask = np.broadcast_to(agree[:, None, :], xs.shape)
    np.testing.assert_array_equal(out[mask], got[mask])
    if kernel == "banded":  # flat weights take the banded branch, point masses the dense one
        fits = _banded_window_fits(u, w)
        if profile == "flat":
            assert fits
        if profile == "point":
            assert not fits
