"""Systematic resample + ancestor gather — kernel 1 of the inner filter step.

Counterpart of ``sequential_monte_carlo_tpu/kernels/resample_walk.py``,
count route (``resample_gather_walk(None, w, xs, u0=u0)``). The kernel is
CUDA C++ for Hopper (``csrc/resample_count.cu``, built by ``_build.py``);
its design note is in that source. :func:`resample_gather_plain` is the same
function in plain PyTorch, with :func:`count_ancestors` as its oracle.
:func:`resample_gather` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors. Either may write one window of the output's
slots (``slot_lo``, ``n_out``): a rank that holds a slice of every row's
particles (particle-axis sharding) resamples its own slots from the row's
whole cloud, bit for bit the whole output's.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def count_ancestors(u0: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Systematic ancestors by closed-form offspring counts, (M, N) int32:
    a_o = #{j : S_hi_j ≤ o} with S_hi_j = ⌈N·cdf_j − u0⌉ (last forced to N),
    clipped to N − 1. The cumsum is accumulated in f64 and the cdf rounded
    to f32, as in the kernel, so that summation order does not move spans."""
    m, n = weights.shape
    cum = torch.cumsum(weights, dim=-1, dtype=torch.float64)
    cdf = (cum / cum[..., -1:]).to(torch.float32)
    s_hi = torch.ceil(n * cdf - u0)
    s_hi[..., -1] = float(n)
    o = torch.arange(n, device=weights.device, dtype=s_hi.dtype).expand(m, n)
    anc = torch.searchsorted(s_hi, o.contiguous(), right=True)
    return torch.clamp(anc, max=n - 1).to(torch.int32)


def resample_gather_plain(u0, weights, xs, slot_lo: int = 0, n_out: int | None = None,
                          out=None):
    """Plain version: (xs gathered along N by the ancestors, ancestors), of
    the output slots [slot_lo, slot_lo + n_out) (all N by default); the
    gathered cloud is written into ``out`` when it is given."""
    n = xs.shape[2]
    anc = count_ancestors(u0, weights)[:, slot_lo:slot_lo + (n if n_out is None else n_out)]
    idx = anc.to(torch.int64)[:, None, :].expand(xs.shape[0], xs.shape[1], anc.shape[1])
    return torch.gather(xs, 2, idx, out=out), anc


def _check(u0, weights, xs, slot_lo: int, n_out: int, out):
    if xs.dim() != 3:
        raise ValueError(f"xs must be (M, C, N), got shape {tuple(xs.shape)}")
    m, c, n = xs.shape
    if not (0 <= slot_lo and 1 <= n_out <= n - slot_lo):
        raise ValueError(f"slots [{slot_lo}, {slot_lo + n_out}) are not a window of N = {n}")
    checks = [("u0", u0, (m, 1)), ("weights", weights, (m, n)), ("xs", xs, (m, c, n))]
    if out is not None:
        checks.append(("out", out, (m, c, n_out)))
    for name, t, shape in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def resample_gather(u0, weights, xs, return_ancestors: bool = False, slot_lo: int = 0,
                    n_out: int | None = None, out=None):
    """Resample every row of the cloud by systematic ancestors and gather.

    Args:
      u0: (M, 1) f32 systematic offsets in [0, 1).
      weights: (M, N) f32 non-negative weights, need not be normalized.
      xs: (M, C, N) f32 cloud, components on the middle axis (any C).
      return_ancestors: also return the (M, n_out) int32 ancestors.
      slot_lo, n_out: the window of output slots [slot_lo, slot_lo + n_out)
        to write (default: all N); the cdf is the whole row's.
      out: optional contiguous (M, C, n_out) f32 tensor that the gathered
        cloud is written into (a buffer a CUDA graph reads and writes).

    Returns (M, C, n_out) f32 ``xs`` gathered along N (and the ancestors),
    equal bit for bit to the whole output's slots of the window.
    CPU tensors take :func:`resample_gather_plain`; CUDA tensors launch the
    kernel and count the launch in ``resample_gather.launches``. The kernel
    takes any N: up to 56,832 (``smc_resample_count_max_n``) it keeps a
    row's marks in shared memory; above, in the ancestors' (M, N) buffer,
    which is then allocated whether or not it is returned.
    """
    n_out = xs.shape[-1] if n_out is None else n_out
    _check(u0, weights, xs, slot_lo, n_out, out)
    if xs.device.type == "cpu":
        out, anc = resample_gather_plain(u0, weights, xs, slot_lo, n_out, out)
        return (out, anc) if return_ancestors else out
    if xs.device.type != "cuda":
        raise ValueError(f"no kernel for device {xs.device}")
    m, c, n = xs.shape
    lib = _build.library()
    if out is None:
        out = (torch.empty_like(xs) if n_out == n
               else torch.empty((m, c, n_out), device=xs.device, dtype=xs.dtype))
    large = n > lib.smc_resample_count_max_n()  # the marks, then every slot's ancestor
    anc = (torch.empty((m, n if large else n_out), device=xs.device, dtype=torch.int32)
           if return_ancestors or large else None)
    with torch.cuda.device(xs.device):
        err = lib.smc_resample_count(
            u0.data_ptr(), weights.data_ptr(), xs.data_ptr(), out.data_ptr(),
            None if anc is None else anc.data_ptr(), m, n, c, slot_lo, n_out,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(lib, err, "resample_count")
    resample_gather.launches += 1
    if not return_ancestors:
        return out
    return out, (anc[:, slot_lo:slot_lo + n_out] if large else anc)


_build.launch_counter(resample_gather)
