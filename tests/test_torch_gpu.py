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
from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
    resample_gather,
    resample_gather_plain,
)
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
