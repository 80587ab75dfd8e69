"""Resample + ancestor gather on explicit sorted grids — the inner filter's
kernel for stratified resampling.

Counterpart of three Pallas TPU kernels with one contract:
``sequential_monte_carlo_tpu/kernels/resample_walk.py::resample_gather_walk``
on an explicit grid u (band route), and ``kernels/resample_pallas.py::
resample_gather`` and ``::resample_gather_bytes``, the dense kernels the walk
falls back to on shapes Mosaic cannot tile. Per row, with
cdf = cumsum(w)/sum(w) and cdf[N−1] set to 1 + 1e-6, the ancestor of u_i is
the first j with u_i ≤ cdf_j (searchsorted side="left"), and the output is xs
gathered by the ancestors. The kernel is CUDA C++ for Hopper
(``csrc/resample_sorted.cu``, built by ``_build.py``); its design note is in
that source. :func:`resample_gather_sorted_plain` is the same function in
plain PyTorch; :func:`resample_gather_sorted` takes it for CPU tensors and
launches the kernel for CUDA tensors. The grid may be shorter than the row,
u (M, n_out): a rank that holds a slice of every row's particles
(particle-axis sharding) passes its window of the whole grid and gets the
whole output's slots of that window, bit for bit.

The cumsum is accumulated in f64 and rounded to an f32 cdf, in the kernel and
in the plain version alike, so that the two agree on the ancestors; against
the JAX package's f32 ``cumsum`` a few slots move at rounding ties.

:func:`systematic_uniforms` and :func:`stratified_uniforms` draw the sorted
grids (the JAX file's XLA helpers of the same names).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_CDF_LAST = 1.0 + 1e-6  # the last bucket covers every u < 1


def systematic_uniforms(generator, m: int, n: int, device=None) -> torch.Tensor:
    """Per-row systematic grids u_i = (i + u0)/n, one u0 per row, (m, n), on
    ``device`` or, when it is not given, on the generator's device."""
    device = generator.device if device is None else device
    u0 = torch.rand((m, 1), generator=generator, device=device)
    return (torch.arange(n, device=device, dtype=torch.float32) + u0) / n


def stratified_uniforms(generator, m: int, n: int, device=None) -> torch.Tensor:
    """Per-row stratified grids u_i = (i + v_i)/n, (m, n), on ``device`` or,
    when it is not given, on the generator's device."""
    device = generator.device if device is None else device
    v = torch.rand((m, n), generator=generator, device=device)
    return (torch.arange(n, device=device, dtype=torch.float32) + v) / n


def sorted_ancestors(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Ancestors of the sorted grids ``u`` under the rows' cdf, (M, N)
    int32: searchsorted-left with the cdf's last entry 1 + 1e-6."""
    cum = torch.cumsum(weights, dim=-1, dtype=torch.float64)
    cdf = (cum / cum[..., -1:]).to(torch.float32)
    cdf[..., -1] = _CDF_LAST
    anc = torch.searchsorted(cdf, u, side="left")
    return torch.clamp(anc, max=weights.shape[-1] - 1).to(torch.int32)


def resample_gather_sorted_plain(u, weights, xs, out=None):
    """Plain version: (xs gathered along N by the ancestors, ancestors),
    (M, C, n_out) and (M, n_out) for the grid u (M, n_out); the gathered
    cloud is written into ``out`` when it is given."""
    anc = sorted_ancestors(u, weights)
    idx = anc.to(torch.int64)[:, None, :].expand(xs.shape[0], xs.shape[1], anc.shape[1])
    return torch.gather(xs, 2, idx, out=out), anc


def _check(u, weights, xs, out):
    if xs.dim() != 3:
        raise ValueError(f"xs must be (M, C, N), got shape {tuple(xs.shape)}")
    m, c, n = xs.shape
    if u.dim() != 2 or not 1 <= u.shape[-1] <= n:
        raise ValueError(f"u must be (M, n_out) with 1 ≤ n_out ≤ {n}, got {tuple(u.shape)}")
    checks = [("u", u, (m, u.shape[-1])), ("weights", weights, (m, n)), ("xs", xs, (m, c, n))]
    if out is not None:
        checks.append(("out", out, (m, c, u.shape[-1])))
    for name, t, shape in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def resample_gather_sorted(u, weights, xs, return_ancestors: bool = False, out=None):
    """Resample every row of the cloud by the sorted grid ``u`` and gather.

    Args:
      u: (M, n_out) f32 sorted uniforms in [0, 1) per row, n_out ≤ N (N:
        a whole grid; fewer: a window of one).
      weights: (M, N) f32 non-negative weights, need not be normalized.
      xs: (M, C, N) f32 cloud, components on the middle axis (any C).
      return_ancestors: also return the (M, n_out) int32 ancestors.
      out: optional contiguous (M, C, n_out) f32 tensor that the gathered
        cloud is written into (a buffer a CUDA graph reads and writes).

    Returns (M, C, n_out) f32 ``xs`` gathered along N (and the ancestors).
    CPU tensors take :func:`resample_gather_sorted_plain`; CUDA tensors
    launch the kernel and count the launch in
    ``resample_gather_sorted.launches``. The kernel takes any N: up to
    57,344 (``smc_resample_sorted_max_n``) it keeps a row's cdf in shared
    memory; above, in an (M, N) scratch in device memory.
    """
    _check(u, weights, xs, out)
    if xs.device.type == "cpu":
        out, anc = resample_gather_sorted_plain(u, weights, xs, out)
        return (out, anc) if return_ancestors else out
    if xs.device.type != "cuda":
        raise ValueError(f"no kernel for device {xs.device}")
    m, c, n = xs.shape
    n_out = u.shape[1]
    lib = _build.library()
    if out is None:
        out = (torch.empty_like(xs) if n_out == n
               else torch.empty((m, c, n_out), device=xs.device, dtype=xs.dtype))
    anc = (torch.empty((m, n_out), device=xs.device, dtype=torch.int32)
           if return_ancestors else None)
    scratch = (torch.empty((m, n), device=xs.device, dtype=torch.float32)
               if n > lib.smc_resample_sorted_max_n() else None)
    with torch.cuda.device(xs.device):
        err = lib.smc_resample_sorted(
            u.data_ptr(), weights.data_ptr(), xs.data_ptr(), out.data_ptr(),
            None if anc is None else anc.data_ptr(),
            None if scratch is None else scratch.data_ptr(), m, n, c, n_out,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(lib, err, "resample_sorted")
    resample_gather_sorted.launches += 1
    return (out, anc) if return_ancestors else out


_build.launch_counter(resample_gather_sorted)
