"""Distribution kit (L0) — the port's subset of
``sequential_monte_carlo_tpu/distributions/core.py``: Normal, LogNormal,
TruncatedNormal, Uniform, Product and TupleProduct.

Each distribution is a frozen dataclass of tensors with
``sample(generator, sample_shape)``, ``log_prob(x)``, ``in_support(x)`` and
``mean()``, ``quantile(p)`` (and ``variance()`` where the JAX package has
it) that broadcast over batch shapes, as in the JAX package. Draws come from an explicit
``torch.Generator`` on the parameters' device (the counterpart of a
``jax.random`` key). Conventions match Distributions.jl: ``Normal``'s
``scale`` is the standard deviation.
"""
from __future__ import annotations

import math

import torch

from ..utils.struct import struct

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _as_like(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a number, an array or a tensor) as a tensor of ``like``'s dtype
    and device: a Python number as a fill on that device, not a copy from
    host memory, so that a step captured into a CUDA graph reads nothing
    from the host; a tensor of that dtype and device as itself."""
    if isinstance(v, (int, float)):
        return torch.full((), float(v), dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _std_pdf(t):
    """The standard normal density φ(t)."""
    return torch.exp(-0.5 * t * t) / math.sqrt(2.0 * math.pi)


@struct
class Normal:
    """Univariate normal N(loc, scale²)."""

    loc: torch.Tensor
    scale: torch.Tensor

    @property
    def batch_shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        eps = torch.randn(shape, generator=generator, device=self.loc.device,
                          dtype=self.loc.dtype)
        return self.loc + self.scale * eps

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - _HALF_LOG_2PI

    def in_support(self, x):
        return torch.isfinite(x)

    def mean(self):
        return self.loc.expand(self.batch_shape)

    def variance(self):
        return (self.scale**2).expand(self.batch_shape)

    def quantile(self, p):
        return self.loc + self.scale * torch.special.ndtri(_as_like(p, self.loc))


@struct
class LogNormal:
    """log X ~ N(mu, sigma²) (Distributions.jl's ``LogNormal(mu, sigma)``)."""

    mu: torch.Tensor
    sigma: torch.Tensor

    @property
    def batch_shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.mu.shape, self.sigma.shape)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        eps = torch.randn(shape, generator=generator, device=self.mu.device,
                          dtype=self.mu.dtype)
        return torch.exp(self.mu + self.sigma * eps)

    def log_prob(self, x):
        lx = torch.log(torch.where(x > 0, x, 1.0))
        z = (lx - self.mu) / self.sigma
        lp = -0.5 * z * z - torch.log(self.sigma) - _HALF_LOG_2PI - lx
        return torch.where(x > 0, lp, -math.inf)

    def in_support(self, x):
        return x > 0

    def mean(self):
        return torch.exp(self.mu + 0.5 * self.sigma**2)

    def quantile(self, p):
        return torch.exp(self.mu + self.sigma * torch.special.ndtri(_as_like(p, self.mu)))


@struct
class TruncatedNormal:
    """N(loc, scale²) truncated to [low, high], sampled by inverse CDF with
    the probability clipped to [1e-7, 1 − 1e-7] (as the JAX package does)."""

    loc: torch.Tensor
    scale: torch.Tensor
    low: torch.Tensor
    high: torch.Tensor

    @property
    def batch_shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape,
                                      self.low.shape, self.high.shape)

    def _cdf_bounds(self):
        fa = torch.special.ndtr((self.low - self.loc) / self.scale)
        fb = torch.special.ndtr((self.high - self.loc) / self.scale)
        return fa, fb

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        fa, fb = self._cdf_bounds()
        u = torch.rand(shape, generator=generator, device=self.loc.device,
                       dtype=self.loc.dtype)
        p = torch.clamp(fa + u * (fb - fa), 1e-7, 1.0 - 1e-7)
        return self.loc + self.scale * torch.special.ndtri(p)

    def log_prob(self, x):
        fa, fb = self._cdf_bounds()
        z = (x - self.loc) / self.scale
        lp = (-0.5 * z * z - torch.log(self.scale) - _HALF_LOG_2PI
              - torch.log(fb - fa))
        return torch.where(self.in_support(x), lp, -math.inf)

    def in_support(self, x):
        return (x >= self.low) & (x <= self.high)

    def mean(self):
        fa, fb = self._cdf_bounds()
        a = (self.low - self.loc) / self.scale
        b = (self.high - self.loc) / self.scale
        return self.loc + self.scale * (_std_pdf(a) - _std_pdf(b)) / (fb - fa)

    def variance(self):
        """σ²·[1 + (αφ(α) − βφ(β))/Z − ((φ(α) − φ(β))/Z)²] with
        Z = Φ(β) − Φ(α); the t·φ(t) terms vanish at infinite bounds."""
        fa, fb = self._cdf_bounds()
        z = fb - fa
        a = (self.low - self.loc) / self.scale
        b = (self.high - self.loc) / self.scale
        tphi = lambda t: torch.where(torch.isfinite(t), t * _std_pdf(t), 0.0)  # noqa: E731
        m1 = (_std_pdf(a) - _std_pdf(b)) / z
        return self.scale**2 * (1.0 + (tphi(a) - tphi(b)) / z - m1 * m1)

    def quantile(self, p):
        """Inverse CDF loc + σ·Φ⁻¹(Φ(α) + p·Z), clipped as the sampler
        clips, so that ``sample`` is ``quantile`` of a uniform."""
        fa, fb = self._cdf_bounds()
        q = torch.clamp(fa + _as_like(p, self.loc) * (fb - fa), 1e-7, 1.0 - 1e-7)
        return self.loc + self.scale * torch.special.ndtri(q)


@struct
class Uniform:
    """Uniform on [low, high]."""

    low: torch.Tensor
    high: torch.Tensor

    @property
    def batch_shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.low.shape, self.high.shape)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        u = torch.rand(shape, generator=generator, device=self.low.device,
                       dtype=self.low.dtype)
        return self.low + (self.high - self.low) * u

    def log_prob(self, x):
        return torch.where(self.in_support(x),
                           -torch.log(self.high - self.low), -math.inf)

    def in_support(self, x):
        return (x >= self.low) & (x <= self.high)

    def mean(self):
        return 0.5 * (self.low + self.high)

    def quantile(self, p):
        return self.low + (self.high - self.low) * _as_like(p, self.low)


@struct
class Product:
    """Independent product over the trailing axis of a batched univariate:
    event shape (k,), ``log_prob`` sums over the last axis."""

    base: object

    @property
    def batch_shape(self) -> torch.Size:
        return self.base.batch_shape[:-1]

    def sample(self, generator, sample_shape=()):
        return self.base.sample(generator, sample_shape)

    def log_prob(self, x):
        return torch.sum(self.base.log_prob(x), dim=-1)

    def in_support(self, x):
        return torch.all(self.base.in_support(x), dim=-1)

    def mean(self):
        return self.base.mean()

    def quantile(self, p):
        return self.base.quantile(p)


@struct
class TupleProduct:
    """Product over a heterogeneous tuple of univariates: draws stack on a
    trailing axis of length k, log-densities sum."""

    components: tuple

    @property
    def batch_shape(self) -> torch.Size:
        return torch.broadcast_shapes(*(c.batch_shape for c in self.components))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        draws = [c.sample(generator, sample_shape).expand(shape)
                 for c in self.components]
        return torch.stack(draws, dim=-1)

    def log_prob(self, x):
        return sum(c.log_prob(x[..., i]) for i, c in enumerate(self.components))

    def in_support(self, x):
        out = self.components[0].in_support(x[..., 0])
        for i, c in enumerate(self.components[1:], start=1):
            out = out & c.in_support(x[..., i])
        return out

    def mean(self):
        return torch.stack([c.mean().expand(self.batch_shape) for c in self.components],
                           dim=-1)

    def quantile(self, p):
        return torch.stack([c.quantile(p) for c in self.components], dim=-1)


def product_distribution(dists) -> TupleProduct:
    """Distributions.jl-style ``product_distribution([...])``."""
    return TupleProduct(tuple(dists))
