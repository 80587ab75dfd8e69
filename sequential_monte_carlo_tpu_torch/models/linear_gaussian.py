"""Linear-Gaussian state-space models (L1) — counterpart of
``sequential_monte_carlo_tpu/models/linear_gaussian.py``:

  x_t ~ N(A x_{t-1}, Q)      x_1 ~ N(x0, Σ0)      y_t ~ N(B·x_t, R)

with Q, R and Σ0 variances, B a row (univariate observation) and Q allowed
to be singular (Hodrick–Prescott). A model's fields carry the θ-cloud's
leading axis: A (M, dx, dx), B (M, dx), Q (M, dx, dx), R (M,), x0 (M, dx),
Σ0 (M, dx, dx) for ``lg_model`` of an (M, 3) θ; no leading axis for one θ.
The distribution methods take states with the θ axis just before the state
axis, (..., M, dx), the layout ``initial_distribution().sample`` draws.

dx = 1 keeps to the univariate ``Normal``/``Product`` path (no
factorizations). The propagate + reweight step runs through the fused kernel
(``kernels/propagate.py``) with :func:`_lg_update` as its per-particle math;
its parameter rows (A, F, B, R), with F·Fᵀ = Q from :meth:`fused_prep`, are
step-invariant, so a filter run packs them once (:meth:`fused_params`).
"""
from __future__ import annotations

import functools
import math

import torch

from ..distributions import MvNormal, Normal, Product
from ..distributions.mvnormal import eigh
from ..kernels.propagate import ElementwiseUpdate, fused_elementwise_step
from .base import as_f32_tensors
from ..utils.struct import struct

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@functools.lru_cache(maxsize=None)
def _lg_update(dx: int):
    """Per-particle LG step at state dimension ``dx`` ≡ JAX ``_lg_update``:
    ``par`` = (A row-major, F row-major, B, R) as (M, 1) columns, ``state``
    and ``normals`` dx (M, N) planes each. Returns (new state planes,
    observation log-weights)."""

    def update(par, y, state, normals):
        A = par[: dx * dx]
        F = par[dx * dx : 2 * dx * dx]
        B = par[2 * dx * dx : 2 * dx * dx + dx]
        r = par[-1]
        x_new = []
        for i in range(dx):
            acc = A[i * dx] * state[0]
            for j in range(1, dx):
                acc = acc + A[i * dx + j] * state[j]
            for j in range(dx):
                acc = acc + F[i * dx + j] * normals[j]
            x_new.append(acc)
        loc = B[0] * x_new[0]
        for i in range(1, dx):
            loc = loc + B[i] * x_new[i]
        delta = y - loc
        logw = -0.5 * delta * delta / r - 0.5 * torch.log(r) - _HALF_LOG_2PI
        return tuple(x_new), logw

    return update


class _LGUpdates(dict):
    """The fused kernel's LG instance at each state dimension dx ≥ 1, made
    at first use: its Triton update lg<dx> (written out for dx = 1 and 2,
    generated from the dx-generic update above them)."""

    def __missing__(self, dx: int) -> ElementwiseUpdate:
        if not isinstance(dx, int) or dx < 1:
            raise KeyError(dx)
        upd = self[dx] = ElementwiseUpdate(plain=_lg_update(dx), triton=f"lg{dx}", n_normals=dx)
        return upd


LG_UPDATES = _LGUpdates()


def _matvec(a, x):
    return (a @ x[..., None])[..., 0]


@struct
class LinearGaussianModel:
    A: torch.Tensor  # (..., dx, dx)
    B: torch.Tensor  # (..., dx) univariate observation row
    Q: torch.Tensor  # (..., dx, dx) state-noise covariance (may be singular)
    R: torch.Tensor  # (...) observation-noise variance
    x0: torch.Tensor  # (..., dx)
    sigma0: torch.Tensor  # (..., dx, dx)

    @property
    def state_dim(self) -> int:
        return self.A.shape[-1]

    @property
    def update(self) -> ElementwiseUpdate:
        return LG_UPDATES[self.state_dim]

    def initial_distribution(self):
        if self.state_dim == 1:
            return Product(Normal(self.x0, torch.sqrt(self.sigma0[..., 0])))
        return MvNormal(self.x0, self.sigma0)

    def transition_distribution(self, x):
        if self.state_dim == 1:
            return Product(Normal(self.A[..., 0, :] * x, torch.sqrt(self.Q[..., 0, :])))
        return MvNormal(_matvec(self.A, x), self.Q)

    def observation_distribution(self, x):
        return Normal(torch.sum(self.B * x, dim=-1), torch.sqrt(self.R))

    @property
    def params_read_host(self) -> bool:
        """Whether :meth:`fused_params` reads the host: at dx > 1 the eigh
        of Q checks its errors there (``torch.linalg.eigh``), so a CUDA
        graph cannot capture it (particle Gibbs builds the kernel parameters
        inside its sweep and keeps the eager loop for such a model)."""
        return self.state_dim > 1

    def fused_prep(self):
        """Any F with F·Fᵀ = Q: √Q at dx = 1, else the eigh factor, which
        takes a singular Q (Hodrick–Prescott)."""
        if self.state_dim == 1:
            return torch.sqrt(self.Q)
        s, V = eigh(self.Q)
        return V * torch.sqrt(torch.clamp(s, min=0.0))[..., None, :]

    def fused_params(self):
        """The fused kernel's (M, 2dx² + dx + 1) parameter rows
        (A row-major, F row-major, B, R) of a θ-cloud model."""
        F = self.fused_prep()
        m = self.A.shape[0]
        return torch.cat([self.A.reshape(m, -1), F.reshape(m, -1),
                          self.B.reshape(m, -1), self.R.reshape(m, 1)],
                         dim=1).contiguous()

    def fused_propagate_reweight(self, y, cloud, seed=None, normals=None,
                                 carry_logw=None, params=None, normalize=True,
                                 row_offset: int = 0, particle_offset: int = 0, out=None):
        """Propagate + reweight (+ normalize) the θ-cloud's (M, dx, N)
        planar cloud through kernel 2 (``params`` from :meth:`fused_params`,
        packed here when not given). Returns (new cloud, log_norm (M, N),
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


def univariate_linear_gaussian(A, B, Q, R, x0=0.0, sigma0=1.0, device="cuda"):
    """Scalar-parameter LG model stored with dx = 1; each parameter is a
    scalar or a θ-cloud's (M,) tensor, broadcast to one batch shape. The
    fields lie on the tensor arguments' device, or on ``device`` when every
    argument is a number."""
    A, B, Q, R, x0, sigma0 = as_f32_tensors(A, B, Q, R, x0, sigma0, device=device)
    batch = torch.broadcast_shapes(A.shape, B.shape, Q.shape, R.shape, x0.shape,
                                   sigma0.shape)
    col = lambda v: v.expand(batch)[..., None]  # noqa: E731
    return LinearGaussianModel(A=col(A)[..., None], B=col(B), Q=col(Q)[..., None],
                               R=R.expand(batch), x0=col(x0),
                               sigma0=col(sigma0)[..., None])


def _as_matrix(v, dx):
    """A scalar means that multiple of the (dx, dx) identity."""
    return v if v.dim() else v * torch.eye(dx, device=v.device)


def multivariate_linear_gaussian(A, B, Q, R, X0=None, Sigma0=None, device="cuda"):
    """LG model with a dx-dimensional state and a univariate observation
    (x0 = 0 and Σ0 = I unless given), on the tensor arguments' device, or on
    ``device`` when none is a tensor."""
    A, B, Q, R, X0, Sigma0 = as_f32_tensors(A, B, Q, R, 0.0 if X0 is None else X0,
                                         1.0 if Sigma0 is None else Sigma0, device=device)
    dx = A.shape[-1]
    return LinearGaussianModel(A=A, B=B, Q=_as_matrix(Q, dx), R=R,
                               x0=X0 if X0.dim() else X0.expand(A.shape[:-1]).clone(),
                               sigma0=_as_matrix(Sigma0, dx))


def unobserved_components(sigma_eps, sigma_eta, x0, device="cuda"):
    """Local-level UC model: x_t ~ N(x_{t-1}, σε), y_t ~ N(x_t, ση),
    x_1 ~ N(x0, σε) (variances)."""
    return univariate_linear_gaussian(A=1.0, B=1.0, Q=sigma_eps, R=sigma_eta,
                                      x0=x0, sigma0=sigma_eps, device=device)


def hodrick_prescott(lam, y, init_cov=1000.0, device="cuda"):
    """Hodrick–Prescott filter model in companion form, with a singular Q, on
    the device of ``y`` when it is a tensor, else on ``device``."""
    y = as_f32_tensors(y, device=device)[0]
    return multivariate_linear_gaussian(
        A=torch.tensor([[2.0, -1.0], [1.0, 0.0]], device=y.device),
        B=torch.tensor([1.0, 0.0], device=y.device),
        Q=torch.tensor([[1.0 / lam, 0.0], [0.0, 0.0]], device=y.device),
        R=1.0,
        X0=torch.stack([3.0 * y[0] - 2.0 * y[1], 2.0 * y[0] - y[1]]),
        Sigma0=init_cov * torch.eye(2, device=y.device),
    )


def uc_model(theta):
    """θ ↦ UC model with θ = (x0, σε, ση) on the last axis."""
    return unobserved_components(sigma_eps=theta[..., 1], sigma_eta=theta[..., 2],
                                 x0=theta[..., 0])


def lg_model(theta):
    """θ ↦ univariate LG with A = θ₀, B = 1, Q = θ₁, R = θ₂, x0 = 0, Σ0 = 1
    (the reference README's golden model) on the last axis of θ."""
    return univariate_linear_gaussian(A=theta[..., 0], B=1.0, Q=theta[..., 1],
                                      R=theta[..., 2], x0=0.0)
