"""Resampling schemes as ancestor-index computations — counterpart of
``sequential_monte_carlo_tpu/ops/resampling.py`` (the systematic resampler
of a particle axis sharded over ranks is ``parallel/collective.py``'s):
``multinomial`` (the θ-resampler,
``SMCConfig.theta_resampling``), ``systematic``, ``stratified``,
``residual`` (remainder-multinomial), ``residual_systematic`` (pointwise
``systematic``) and ``metropolis`` (Murray, arXiv 1202.6163).

Each scheme is ``(generator, weights, n) -> ancestors`` over the trailing
axis of ``weights``, batched over the leading axes, on the weights' device.
The batched inner filter resamples systematic, ``residual_systematic`` and
stratified grids in the fused kernels (``kernels/resample_walk.py``,
``kernels/resample_sorted.py``) and the other schemes here, as the JAX
package does on its XLA route.
"""
from __future__ import annotations

import torch


def _row_cumsum(w: torch.Tensor) -> torch.Tensor:
    """cumsum along the last axis, the same bits run to run. On CUDA torch
    scans a tensor of one row with CUB's decoupled look-back, whose float
    sums past one tile can group otherwise from run to run (so a replayed
    and an eager run could part); such a row is scanned beside a copy of
    itself by the per-row kernel, whose order is fixed. Every float cdf of
    the resamplers here goes through it (the inverse cdf, residual's
    remainders)."""
    if w.is_cuda and w.numel() == w.shape[-1] > 1:
        return torch.cumsum(w.reshape(1, -1).expand(2, -1), dim=-1)[0].reshape(w.shape)
    return torch.cumsum(w, dim=-1)


def _inverse_cdf(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Ancestors of uniforms u ∈ [0, 1) under the weights' CDF
    (searchsorted side="left", clipped to the last index)."""
    cdf = _row_cumsum(weights)
    cdf = cdf / cdf[..., -1:]
    idx = torch.searchsorted(cdf, u.contiguous())
    return torch.clamp(idx, max=weights.shape[-1] - 1).to(torch.int32)


def multinomial(generator, weights, n=None):
    """IID draws from Categorical(w)."""
    n = n or weights.shape[-1]
    u = torch.rand(weights.shape[:-1] + (n,), generator=generator,
                   device=weights.device, dtype=weights.dtype)
    return _inverse_cdf(u, weights)


def systematic(generator, weights, n=None):
    """One uniform offset per row on the stride-1/n grid u_i = (i + u0)/n."""
    n = n or weights.shape[-1]
    u0 = torch.rand(weights.shape[:-1] + (1,), generator=generator,
                    device=weights.device, dtype=weights.dtype)
    u = (torch.arange(n, device=weights.device, dtype=weights.dtype) + u0) / n
    return _inverse_cdf(u, weights)


def stratified(generator, weights, n=None):
    """One uniform per stratum: u_i = (i + v_i)/n, v_i ~ U[0, 1)."""
    n = n or weights.shape[-1]
    v = torch.rand(weights.shape[:-1] + (n,), generator=generator,
                   device=weights.device, dtype=weights.dtype)
    u = (torch.arange(n, device=weights.device, dtype=weights.dtype) + v) / n
    return _inverse_cdf(u, weights)


def _counts_to_ancestors(counts: torch.Tensor, n: int) -> torch.Tensor:
    """Sorted ancestors from offspring counts that sum to n per row: index i
    repeated counts[i] times (cumsum + searchsorted)."""
    cum = torch.cumsum(counts, dim=-1)
    k = torch.arange(n, device=counts.device, dtype=cum.dtype).expand(cum.shape[:-1] + (n,))
    return torch.searchsorted(cum, k.contiguous(), right=True).to(torch.int32)


def _residual_from_uniforms(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """:func:`residual`'s deterministic core, given its n uniforms u (…, n)."""
    size, n = weights.shape[-1], u.shape[-1]
    w = weights / torch.sum(weights, dim=-1, keepdim=True)
    nw = n * w
    floor = torch.floor(nw)
    n_det = torch.sum(floor, dim=-1).to(torch.int32)  # Σ floor(n·w) ≤ n
    cdf = _row_cumsum(nw - floor)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=torch.finfo(w.dtype).tiny)
    draws = torch.clamp(torch.searchsorted(cdf, u.contiguous()), max=size - 1)
    # only the first R = n − Σ floor draws are live
    live = torch.arange(n, device=u.device) < (n - n_det)[..., None]
    counts = floor.to(torch.int64).scatter_add(-1, draws, live.to(torch.int64))
    return _counts_to_ancestors(counts, n)


def residual(generator, weights, n=None):
    """Residual (remainder-multinomial) resampling, Liu & Chen (1998): the
    floor(n·w_i) copies of every particle, then R = n − Σ floor(n·w_i)
    multinomial draws from the remainders n·w_i − floor(n·w_i). Unbiased;
    not :func:`systematic`, whose counts never exceed ceil(n·w_i)."""
    n = n or weights.shape[-1]
    u = torch.rand(weights.shape[:-1] + (n,), generator=generator,
                   device=weights.device, dtype=weights.dtype)
    return _residual_from_uniforms(u, weights)


def residual_systematic(generator, weights, n=None):
    """Residual resampling with a systematic pass over the remainders: for
    the same uniform, pointwise equal to :func:`systematic` (the JAX
    package's docstring proves it), so it is that scheme."""
    return systematic(generator, weights, n)


def metropolis(generator, weights, n=None, n_iters: int = 16):
    """Metropolis resampler (Murray, arXiv 1202.6163): each output runs an
    independent Metropolis chain of ``n_iters`` steps over uniform ancestor
    proposals, accepting j over i with probability w_j / w_i. No cumulative
    sum; a bias that decays geometrically in ``n_iters``."""
    size = weights.shape[-1]
    n = n or size
    shape = weights.shape[:-1] + (n,)
    kw = dict(generator=generator, device=weights.device)
    idx = torch.randint(0, size, shape, **kw)
    for _ in range(n_iters):
        prop = torch.randint(0, size, shape, **kw)
        u = torch.rand(shape, dtype=weights.dtype, **kw)
        ratio = (torch.gather(weights, -1, prop)
                 / torch.clamp(torch.gather(weights, -1, idx), min=1e-38))
        idx = torch.where(u < ratio, prop, idx)
    return idx.to(torch.int32)


_SCHEMES = {"multinomial": multinomial, "systematic": systematic,
            "stratified": stratified, "residual": residual,
            "residual_systematic": residual_systematic, "metropolis": metropolis}


def get_resampler(name: str):
    try:
        return _SCHEMES[name]
    except KeyError:
        raise ValueError(
            f"unknown resampling scheme {name!r}; one of {sorted(_SCHEMES)}"
        ) from None


def resample(generator, weights, n=None, scheme: str = "multinomial"):
    """Ancestors by the named scheme (multinomial by default, the
    reference's)."""
    return get_resampler(scheme)(generator, weights, n)
