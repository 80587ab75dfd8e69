"""Fused UC-SV propagate + reweight (+ optional normalize) — the auxiliary
particle filter's second stage on the UC-SV model.

Counterpart of ``sequential_monte_carlo_tpu/kernels/ucsv_pallas.py::
ucsv_propagate_reweight``: for every θ-row m and particle i it draws three
N(0, 1) normals, moves the planar state (x, log σε, log ση) by the UC-SV
transition with the row's vol-of-vols γε[m], γη[m], and computes the
observation log-weight; with ``normalize`` it also normalizes each row
(log_norm, lse, ess) as the JAX kernel's epilogue does. The kernel is CUDA
C++ for Hopper (``csrc/ucsv_propagate.cu``, built by ``_build.py``); its
design note is in that source. It is written independently of the fused
propagate kernel's UC-SV instance (``kernels/propagate.py``, Triton) and
draws the same normals at the same seed — Philox keyed by (seed,
row_offset + row, particle_offset + particle) — so each checks the other.
A slice of every row's particles (particle-axis sharding) is launched with
its first particle's index, ``particle_offset``, and draws what the whole
launch draws at those particles.

:func:`ucsv_propagate_reweight_plain` is the same function in plain PyTorch
with the normals injected; :func:`ucsv_propagate_reweight` takes it for CPU
tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .propagate import check_out

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def ucsv_propagate_reweight_plain(y, gamma_eps, gamma_eta, cloud, normals,
                                  normalize: bool = False, out=None):
    """Plain version with injected normals (3, M, N); the arguments and
    results are :func:`ucsv_propagate_reweight`'s."""
    ge, gn = gamma_eps[:, None], gamma_eta[:, None]
    x, lse, lsn = cloud[:, 0], cloud[:, 1], cloud[:, 2]
    z0, z1, z2 = normals
    x_new = x + torch.exp(0.5 * lse) * z0
    lse_new = lse + ge * z1
    lsn_new = lsn + gn * z2
    zz = (y - x_new) * torch.exp(-0.5 * lsn_new)
    logw = -0.5 * zz * zz - 0.5 * lsn_new - _HALF_LOG_2PI
    new = torch.stack((x_new, lse_new, lsn_new), dim=1, out=None if out is None else out[0])
    if not normalize:
        return new, (logw if out is None else out[1].copy_(logw))
    mx = torch.amax(logw, dim=-1, keepdim=True)
    e = torch.exp(logw - mx)
    s = torch.sum(e, dim=-1, keepdim=True)
    row_lse = mx + torch.log(s)
    log_norm = torch.sub(logw, row_lse, out=None if out is None else out[1])
    return new, log_norm, row_lse, (s * s) / torch.sum(e * e, dim=-1, keepdim=True)


def _check(y, gamma_eps, gamma_eta, cloud, draws, draws_name, draws_dtype):
    if cloud.dim() != 3 or cloud.shape[1] != 3:
        raise ValueError(f"cloud must be (M, 3, N), got {tuple(cloud.shape)}")
    m, _, n = cloud.shape
    if cloud.stride(2) != 1:
        raise ValueError("cloud must have unit stride along N")
    if y.numel() != 1:
        raise ValueError(f"y must hold one observation, got shape {tuple(y.shape)}")
    for name, g in (("gamma_eps", gamma_eps), ("gamma_eta", gamma_eta)):
        if tuple(g.shape) != (m,):
            raise ValueError(f"{name} must be ({m},), got {tuple(g.shape)}")
    for name, t, dtype in (("y", y, torch.float32), ("gamma_eps", gamma_eps, torch.float32),
                           ("gamma_eta", gamma_eta, torch.float32),
                           ("cloud", cloud, torch.float32), (draws_name, draws, draws_dtype)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != cloud.device:
            raise ValueError(f"{name} is on {t.device}, cloud on {cloud.device}")


def ucsv_propagate_reweight(seed, y, gamma_eps, gamma_eta, cloud, row_offset: int = 0,
                            normalize: bool = False, normals=None, particle_offset: int = 0,
                            out=None):
    """One fused UC-SV propagate + reweight step for all (M, N) particles.

    Args:
      seed: (1,) int64 Philox seed on the device (CUDA tensors).
      y: the observation, a one-element f32 tensor on the cloud's device.
      gamma_eps, gamma_eta: (M,) f32 per-row vol-of-vols (any stride).
      cloud: (M, 3, N) f32 planar cloud (x, log σε, log ση), read through its
        row and plane strides (unit stride along N), so a view is not copied.
      row_offset: global index of row 0 (θ-sharding), for the draws.
      normalize: also normalize each row.
      normals: (3, M, N) f32 draws (CPU tensors: the plain version).
      particle_offset: global index of particle 0 (particle-axis sharding),
        for the draws: any offset ≥ 0 and any N. A call on particles
        p..p+N of every row draws what those columns of the whole-row call
        draw, and its new cloud and raw log-weights are those columns' bit
        for bit.
      out: optional (new cloud (M, 3, N), logw or log_norm (M, N)),
        contiguous f32, written in place with the bits the call would
        return (the buffers a CUDA graph reads and writes).

    Returns (new cloud (M, 3, N), logw (M, N)), or with ``normalize``
    (new cloud, log_norm (M, N), lse (M, 1), ess (M, 1)). CUDA launches are
    counted in ``ucsv_propagate_reweight.launches``.
    """
    check_out(out, cloud)
    if cloud.device.type == "cpu":
        if normals is None:
            raise ValueError("on the CPU the plain version takes injected normals")
        _check(y, gamma_eps, gamma_eta, cloud, normals, "normals", torch.float32)
        if tuple(normals.shape) != (3,) + tuple(cloud.shape[::2]):
            raise ValueError(f"normals must be (3, M, N), got {tuple(normals.shape)}")
        return ucsv_propagate_reweight_plain(y, gamma_eps, gamma_eta, cloud, normals, normalize,
                                             out)
    if cloud.device.type != "cuda":
        raise ValueError(f"no kernel for device {cloud.device}")
    if seed is None:
        raise ValueError("the kernel draws its own normals: pass seed=")
    _check(y, gamma_eps, gamma_eta, cloud, seed, "seed", torch.int64)
    m, _, n = cloud.shape
    if particle_offset < 0:
        raise ValueError(f"particle_offset must be ≥ 0, got {particle_offset}")
    if out is None:
        new = torch.empty((m, 3, n), device=cloud.device, dtype=torch.float32)
        logw = torch.empty((m, n), device=cloud.device, dtype=torch.float32)
    else:
        new, logw = out
    lse = torch.empty((m, 1), device=cloud.device, dtype=torch.float32) if normalize else None
    ess = torch.empty((m, 1), device=cloud.device, dtype=torch.float32) if normalize else None
    lib = _build.library()
    with torch.cuda.device(cloud.device):
        err = lib.smc_ucsv_propagate(
            seed.data_ptr(), y.data_ptr(), gamma_eps.data_ptr(), gamma_eps.stride(0),
            gamma_eta.data_ptr(), gamma_eta.stride(0), cloud.data_ptr(), cloud.stride(0),
            cloud.stride(1), new.data_ptr(), logw.data_ptr(),
            None if lse is None else lse.data_ptr(), None if ess is None else ess.data_ptr(),
            m, n, row_offset, particle_offset,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _build.check(lib, err, "ucsv_propagate")
    ucsv_propagate_reweight.launches += 1
    return (new, logw, lse, ess) if normalize else (new, logw)


_build.launch_counter(ucsv_propagate_reweight)
