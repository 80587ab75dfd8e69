"""Stock–Watson unobserved-components stochastic-volatility model (L1) —
counterpart of ``sequential_monte_carlo_tpu/models/ucsv.py``.

3-dim state s = (x, log σε, log ση):

  x_t      ~ N(x_{t-1},      exp(½ log σε,t-1))
  logσε,t  ~ N(log σε,t-1,   γε)
  logση,t  ~ N(log ση,t-1,   γη)
  y_t      ~ N(x_t,          exp(½ log ση,t))

A model's fields are tensors of one shape: scalars for one θ, (M,) for the
θ-cloud (``ucsv_model`` of an (M, 4) θ). The propagate + reweight +
normalize step runs through the fused kernel (``kernels/propagate.py``) with
:func:`ucsv_update` as its per-particle math; the step without the normalize
(the auxiliary particle filter's second stage) runs through the hand-written
UC-SV kernel (``kernels/ucsv.py``), which draws the same normals.
"""
from __future__ import annotations

import math

import torch

from ..distributions import Normal, TupleProduct
from ..kernels.propagate import ElementwiseUpdate, fused_elementwise_step
from ..kernels.ucsv import ucsv_propagate_reweight
from ..utils.struct import struct
from .base import as_f32_tensors

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def ucsv_update(par, y, state, normals):
    """Per-particle UC-SV step ≡ JAX ``_ucsv_update``: ``par`` = (γε, γη)
    as (M, 1) columns, ``state`` and ``normals`` three (M, N) planes each.
    Returns (new state planes, observation log-weights)."""
    ge, gn = par
    x, lse, lsn = state
    z0, z1, z2 = normals
    x_new = x + torch.exp(0.5 * lse) * z0
    lse_new = lse + ge * z1
    lsn_new = lsn + gn * z2
    s_inv = torch.exp(-0.5 * lsn_new)
    zz = (y - x_new) * s_inv
    logw = -0.5 * zz * zz - 0.5 * lsn_new - _HALF_LOG_2PI
    return (x_new, lse_new, lsn_new), logw


UCSV_UPDATE = ElementwiseUpdate(plain=ucsv_update, triton="ucsv", n_normals=3)


@struct
class UCSVModel:
    gamma_eps: torch.Tensor  # vol-of-vol of the trend-noise log-variance (std)
    gamma_eta: torch.Tensor  # vol-of-vol of the obs-noise log-variance (std)
    x0: torch.Tensor  # initial trend level
    log_sigma_eps0: torch.Tensor  # initial log σε
    log_sigma_eta0: torch.Tensor  # initial log ση

    update = UCSV_UPDATE

    @property
    def state_dim(self) -> int:
        return 3

    def initial_distribution(self):
        return TupleProduct((
            Normal(self.x0, torch.exp(0.5 * self.log_sigma_eps0)),
            Normal(self.log_sigma_eps0, self.gamma_eps),
            Normal(self.log_sigma_eta0, self.gamma_eta),
        ))

    def transition_distribution(self, s):
        x, log_se, log_sn = s[..., 0], s[..., 1], s[..., 2]
        return TupleProduct((
            Normal(x, torch.exp(0.5 * log_se)),
            Normal(log_se, self.gamma_eps),
            Normal(log_sn, self.gamma_eta),
        ))

    def observation_distribution(self, s):
        return Normal(s[..., 0], torch.exp(0.5 * s[..., 2]))

    def fused_params(self):
        """The fused kernel's (M, 2) parameter rows (γε, γη)."""
        m = self.x0.shape[0]
        return torch.stack([self.gamma_eps.expand(m), self.gamma_eta.expand(m)], dim=1)

    def fused_propagate_reweight(self, y, cloud, seed=None, normals=None,
                                 carry_logw=None, params=None, normalize=True,
                                 row_offset: int = 0, particle_offset: int = 0, out=None):
        """Propagate + reweight the θ-cloud's (M, 3, N) planar cloud. With
        ``normalize`` (kernel 2) returns (new cloud, log_norm (M, N),
        lse (M, 1), ess (M, 1)); without (the UC-SV kernel, which takes no
        carried log-weights) returns (new cloud, logw (M, N)). ``row_offset``,
        ``particle_offset``: the global index of row 0 and of particle 0 in
        the kernels' draws (θ- and particle-axis sharding); the injected
        normals of the plain versions are already those rows' and particles'.
        ``out``: the (new cloud, log-weights) buffers to write (the
        kernels' ``out=``)."""
        if params is None:
            params = self.fused_params()
        if normalize:
            return fused_elementwise_step(self.update, params, cloud, y, seed=seed,
                                          normals=normals, row_offset=row_offset,
                                          carry_logw=carry_logw, particle_offset=particle_offset,
                                          out=out)
        if carry_logw is not None:
            raise ValueError("carry_logw requires normalize=True")
        return ucsv_propagate_reweight(seed, y, params[:, 0], params[:, 1], cloud,
                                       row_offset=row_offset, normals=normals,
                                       particle_offset=particle_offset, out=out)


def unobserved_components_stochastic_volatility(x0, gamma_eps, gamma_eta, log_sigma_eps,
                                                log_sigma_eta, device="cuda") -> UCSVModel:
    """≡ the JAX package's keyword constructor (the reference's
    state_space_models.jl:225-227): one UC-SV model, or a θ-cloud where the
    arguments are (M,) tensors, on the tensor arguments' device, or on
    ``device`` when every argument is a number."""
    x0, ge, gn, lse, lsn = as_f32_tensors(x0, gamma_eps, gamma_eta, log_sigma_eps,
                                          log_sigma_eta, device=device)
    return UCSVModel(gamma_eps=ge, gamma_eta=gn, x0=x0, log_sigma_eps0=lse, log_sigma_eta0=lsn)


def ucsv_model(theta: torch.Tensor) -> UCSVModel:
    """θ ↦ UCSV with θ = (γ, x0, log σε0, log ση0) on the last axis and a
    shared vol-of-vol γ (the inflation example's 4-parameter model)."""
    return UCSVModel(
        gamma_eps=theta[..., 0],
        gamma_eta=theta[..., 0],
        x0=theta[..., 1],
        log_sigma_eps0=theta[..., 2],
        log_sigma_eta0=theta[..., 3],
    )
