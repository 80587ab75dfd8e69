"""Canonical stochastic-volatility model (L1) — counterpart of
``sequential_monte_carlo_tpu/models/stochastic_volatility.py``, an AR(1)
log-volatility with a nonlinear observation density:

  x_1 ~ N(mu, sigma² / (1 − phi²))
  x_t ~ N(mu + phi (x_{t-1} − mu), sigma²)
  y_t ~ N(0, exp(x_t))

Fields are scalars for one θ, (M,) for the θ-cloud (``sv_model`` of an
(M, 3) θ); states carry a trailing state axis of length 1, with the θ axis
just before it. The propagate + reweight step runs through the fused kernel
(``kernels/propagate.py``) with :func:`sv_update` as its per-particle math.
"""
from __future__ import annotations

import math

import torch

from ..distributions import Normal, Product
from ..kernels.propagate import ElementwiseUpdate, fused_elementwise_step
from ..utils.struct import struct

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def sv_update(par, y, state, normals):
    """Per-particle SV step ≡ JAX ``_sv_update``: ``par`` = (mu, phi, sigma)
    as (M, 1) columns, one state plane and one normal plane."""
    mu, phi, sigma = par
    (x,) = state
    (z,) = normals
    x_new = mu + phi * (x - mu) + sigma * z
    logw = -0.5 * (y * y) * torch.exp(-x_new) - 0.5 * x_new - _HALF_LOG_2PI
    return (x_new,), logw


SV_UPDATE = ElementwiseUpdate(plain=sv_update, triton="sv", n_normals=1)


@struct
class StochasticVolatilityModel:
    mu: torch.Tensor
    phi: torch.Tensor
    sigma: torch.Tensor  # std of the log-vol innovations

    update = SV_UPDATE

    @property
    def state_dim(self) -> int:
        return 1

    def initial_distribution(self):
        scale = self.sigma / torch.sqrt(1.0 - self.phi**2)
        return Product(Normal(self.mu[..., None], scale[..., None]))

    def transition_distribution(self, x):
        mu = self.mu[..., None]
        loc = mu + self.phi[..., None] * (x - mu)
        return Product(Normal(loc, self.sigma[..., None].expand(loc.shape)))

    def observation_distribution(self, x):
        return Normal(torch.zeros_like(x[..., 0]), torch.exp(0.5 * x[..., 0]))

    def fused_params(self):
        """The fused kernel's (M, 3) parameter rows (mu, phi, sigma)."""
        m = self.mu.shape[0]
        return torch.stack([p.expand(m) for p in (self.mu, self.phi, self.sigma)],
                           dim=1)

    def fused_propagate_reweight(self, y, cloud, seed=None, normals=None,
                                 carry_logw=None, params=None, normalize=True,
                                 row_offset: int = 0, particle_offset: int = 0, out=None):
        """Propagate + reweight (+ normalize) the θ-cloud's (M, 1, N) planar
        cloud through kernel 2. Returns (new cloud, log_norm (M, N),
        lse (M, 1), ess (M, 1)), or with ``normalize=False`` (new cloud,
        logw (M, N)). ``row_offset``, ``particle_offset``: the global index
        of row 0 and of particle 0 in the kernel's draws (θ- and
        particle-axis sharding). ``out``: the (new cloud, log-weights)
        buffers to write (the kernel's ``out=``)."""
        if params is None:
            params = self.fused_params()
        return fused_elementwise_step(self.update, params, cloud, y, seed=seed,
                                      normals=normals, row_offset=row_offset,
                                      carry_logw=carry_logw, normalize=normalize,
                                      particle_offset=particle_offset, out=out)


def stochastic_volatility(mu=-1.0, phi=0.95, sigma=0.3, device="cuda"):
    """One SV model, on the tensor arguments' device, or on ``device`` when
    every argument is a number."""
    device = next((v.device for v in (mu, phi, sigma) if isinstance(v, torch.Tensor)), device)
    f = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return StochasticVolatilityModel(mu=f(mu), phi=f(phi), sigma=f(sigma))


def sv_model(theta):
    """θ ↦ SV model with θ = (mu, phi, sigma) on the last axis."""
    return StochasticVolatilityModel(mu=theta[..., 0], phi=theta[..., 1],
                                     sigma=theta[..., 2])
