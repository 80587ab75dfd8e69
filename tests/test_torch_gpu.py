"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on a GPU (``gpu`` marker; they skip where there is no CUDA device).

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from sequential_monte_carlo_tpu_torch.kernels.propagate import (
    fused_elementwise_step,
    fused_elementwise_step_plain,
)
from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
    resample_gather_sorted,
    resample_gather_sorted_plain,
)
from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
    resample_gather,
    resample_gather_plain,
)
from sequential_monte_carlo_tpu_torch.models.linear_gaussian import LG_UPDATES
from sequential_monte_carlo_tpu_torch.models.stochastic_volatility import SV_UPDATE
from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1024, 8192])
@pytest.mark.parametrize("c", [3, 4])
def test_resample_kernel_matches_plain(cuda, n, c):
    """Kernel 1: ancestors equal to the plain version's on all but < 1e-3
    of slots (both sum in f64), output ≡ xs gathered by them, one launch
    counted."""
    rng = np.random.default_rng(7)
    a = 2.0 * rng.standard_normal((64, n))
    w = np.exp(a - a.max(-1, keepdims=True))
    w = torch.tensor(w / w.sum(-1, keepdims=True), dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((64, c, n)), dtype=torch.float32, device=cuda)
    u0 = torch.tensor(rng.random((64, 1)), dtype=torch.float32, device=cuda)
    before = resample_gather.launches
    out, anc = resample_gather(u0, w, xs, return_ancestors=True)
    assert resample_gather.launches == before + 1
    ref, anc_ref = resample_gather_plain(u0, w, xs)
    assert (anc != anc_ref).float().mean().item() < 1e-3
    assert torch.equal(out, torch.gather(xs, 2, anc.long()[:, None, :].expand(xs.shape)))


@pytest.mark.parametrize("n", [1000, 1024, 8192])
def test_fused_step_kernel_matches_plain(cuda, n):
    """Kernel 2: the plain version, fed the normals recovered from the
    kernel's state deltas, gives the kernel's outputs to rtol 1e-5 (exp and
    log in another library); the draws do not depend on the row's
    neighbours (row_offset shifts them by rows)."""
    rng = np.random.default_rng(8)
    scale = np.array([1.0, 0.5, 0.5])[None, :, None]
    state = torch.tensor(rng.standard_normal((64, 3, n)) * scale, dtype=torch.float32,
                         device=cuda)
    params = torch.tensor(rng.uniform(0.05, 0.5, (64, 2)), dtype=torch.float32, device=cuda)
    y = torch.tensor(1.3, device=cuda)
    seed = torch.tensor([12345], device=cuda)
    new, log_norm, lse, ess = fused_elementwise_step(UCSV_UPDATE, params, state, y, seed=seed)
    z = torch.stack([(new[:, 0] - state[:, 0]) / torch.exp(0.5 * state[:, 1]),
                     (new[:, 1] - state[:, 1]) / params[:, :1],
                     (new[:, 2] - state[:, 2]) / params[:, 1:]])
    ref = fused_elementwise_step_plain(UCSV_UPDATE, params, state, y, z)
    for a, b in zip((new, log_norm, lse, ess), ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # rows 32.. of the full call are rows 0.. of a call on them at offset 32
    half = fused_elementwise_step(UCSV_UPDATE, params[32:].contiguous(),
                                  state[32:].contiguous(), y, seed=seed, row_offset=32)
    assert torch.equal(half[0], new[32:])


@pytest.mark.parametrize("n", [1000, 1024, 8192])
@pytest.mark.parametrize("weights", ["skewed", "point"])
def test_sorted_resample_kernel_matches_plain(cuda, n, weights):
    """Sorted-grid kernel on stratified grids (N=1000 is a shape the TPU
    walk cannot tile): ancestors equal to the plain version's on all but
    < 1e-3 of slots (both sum in f64), output ≡ xs gathered by them, within
    [0, N), one launch counted."""
    rng = np.random.default_rng(9)
    m = 64
    if weights == "point":
        w = np.zeros((m, n))
        w[np.arange(m), rng.integers(0, n, m)] = 1.0
    else:
        a = 2.0 * rng.standard_normal((m, n))
        w = np.exp(a - a.max(-1, keepdims=True))
    w = torch.tensor(w, dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((m, 3, n)), dtype=torch.float32, device=cuda)
    u = ((torch.arange(n, device=cuda) + torch.tensor(rng.random((m, n)), device=cuda)) / n).float()
    before = resample_gather_sorted.launches
    out, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
    assert resample_gather_sorted.launches == before + 1
    ref, anc_ref = resample_gather_sorted_plain(u, w, xs)
    assert (anc != anc_ref).float().mean().item() < 1e-3
    assert bool(torch.all((anc >= 0) & (anc < n)))
    assert torch.equal(out, torch.gather(xs, 2, anc.long()[:, None, :].expand(xs.shape)))


def _instance(name, rng, m):
    """(update, (M, P) params, state scale) of a kernel-2 instance, with a
    non-singular F for LG so that the normals can be recovered."""
    if name == "sv":
        p = np.stack([rng.normal(-1, 0.3, m), rng.uniform(0.5, 0.95, m),
                      rng.uniform(0.1, 0.5, m)], 1)
        return SV_UPDATE, p
    dx = int(name[-1])
    a = rng.uniform(-0.9, 0.9, (m, dx, dx))
    f = np.tril(rng.uniform(0.3, 1.0, (m, dx, dx)))
    p = np.concatenate([a.reshape(m, -1), f.reshape(m, -1), rng.uniform(0.5, 1.5, (m, dx)),
                        rng.uniform(0.3, 1.0, (m, 1))], 1)
    return LG_UPDATES[dx], p


def _assert_standard_normals(z):
    """The recovered normals (K, M, N), over ≥ 5·10⁵ draws each, look
    standard and independent: |mean| < 5e-3, |var − 1| < 1e-2, |corr| <
    5e-3 (about 3.5, 5 and 3.5 standard errors). An update that scales or
    mixes the draws wrongly (Fᵀ in place of F, σ² in place of σ) fails."""
    flat = z.reshape(z.shape[0], -1).double()
    assert flat.shape[1] >= 500_000
    assert flat.mean(1).abs().max().item() < 5e-3
    assert (flat.var(1) - 1.0).abs().max().item() < 1e-2
    if flat.shape[0] > 1:
        corr = torch.corrcoef(flat)
        assert (corr - torch.diag(torch.diag(corr))).abs().max().item() < 5e-3


def _recover_normals(name, params, state, new):
    """The normals the kernel drew, from the state deltas."""
    if name == "sv":
        mu, phi, sig = (params[:, i:i + 1] for i in range(3))
        return ((new[:, 0] - mu - phi * (state[:, 0] - mu)) / sig)[None]
    dx = int(name[-1])
    m = params.shape[0]
    a = params[:, :dx * dx].reshape(m, dx, dx)
    f = params[:, dx * dx:2 * dx * dx].reshape(m, dx, dx)
    return torch.linalg.solve_triangular(f, new - a @ state, upper=False).transpose(0, 1)


@pytest.mark.parametrize("n", [1000, 8192])
@pytest.mark.parametrize("name,carry", [("lg1", False), ("lg1", True), ("lg2", False),
                                        ("sv", False), ("sv", True)])
def test_fused_step_instances_match_plain(cuda, n, name, carry):
    """Kernel 2's LG (dx 1, 2) and SV instances, with and without the
    carried log-weights: the plain version, fed the normals recovered from
    the kernel's state deltas, gives the kernel's outputs to rtol 1e-5, and
    those normals have standard moments (the first check holds whatever the
    update does; the second shows it right)."""
    rng = np.random.default_rng(10)
    m = 512
    update, p = _instance(name, rng, m)
    params = torch.tensor(p, dtype=torch.float32, device=cuda)
    state = torch.tensor(rng.standard_normal((m, update.n_normals, n)), dtype=torch.float32,
                         device=cuda)
    carry_logw = None
    if carry:
        a = 3.0 * rng.standard_normal((m, n))
        carry_logw = torch.tensor(a - np.log(np.exp(a).sum(-1, keepdims=True)),
                                  dtype=torch.float32, device=cuda)
        carry_logw[1] = -60.0  # a row carrying very negative log-weights
    y = torch.tensor(0.6, device=cuda)
    seed = torch.tensor([4321], device=cuda)
    got = fused_elementwise_step(update, params, state, y, seed=seed, carry_logw=carry_logw)
    z = _recover_normals(name, params, state, got[0])
    ref = fused_elementwise_step_plain(update, params, state, y, z, carry_logw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert bool(torch.all(torch.isfinite(got[2])))
    _assert_standard_normals(z)
