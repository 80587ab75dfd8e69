"""Resampling schemes as ancestor-index computations — the port's subset of
``sequential_monte_carlo_tpu/ops/resampling.py``: ``multinomial`` (the
θ-resampler, ``SMCConfig.theta_resampling``), ``systematic`` and
``stratified``.

Each scheme is ``(generator, weights, n) -> ancestors`` over the trailing
axis of ``weights``, by an inverse-CDF ``searchsorted``. The batched inner
filter does not come here: its resample is fused with the ancestor gather in
``kernels/resample_walk.py`` (systematic) and ``kernels/resample_sorted.py``
(stratified).
"""
from __future__ import annotations

import torch


def _inverse_cdf(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Ancestors of uniforms u ∈ [0, 1) under the weights' CDF
    (searchsorted side="left", clipped to the last index)."""
    cdf = torch.cumsum(weights, dim=-1)
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


_SCHEMES = {"multinomial": multinomial, "systematic": systematic,
            "stratified": stratified}


def get_resampler(name: str):
    try:
        return _SCHEMES[name]
    except KeyError:
        raise ValueError(
            f"unknown resampling scheme {name!r}; one of {sorted(_SCHEMES)} "
            "(the others come with ROADMAP Queue 1 item 4)"
        ) from None
