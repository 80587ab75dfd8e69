"""Multivariate normal with a possibly singular covariance — counterpart of
``sequential_monte_carlo_tpu/distributions/mvnormal.py``.

A Cholesky factor drives the full-rank path; where it fails (the
Hodrick–Prescott model's Q = [[1/λ, 0], [0, 0]] is singular), a symmetric
eigendecomposition with eigenvalues clipped at zero takes over, per matrix:
sampling works for any PSD covariance, and ``log_prob`` is the Gaussian
density on the support subspace (pseudo-inverse, pseudo-determinant), equal
to the usual density at full rank. Both paths form the Mahalanobis term in
the factor's basis, as the JAX package does, so f32 results agree with it to
rounding. ``allow_singular=False`` declares the covariance full rank: the
Cholesky path alone, no eigendecomposition (NaN where the factor fails, as
the JAX package's Cholesky gives).
"""
from __future__ import annotations

import math

import torch

from ..utils.struct import struct

_LOG_2PI = math.log(2.0 * math.pi)
_EIG_TOL = 1e-10


def eigh(cov):
    """``torch.linalg.eigh``, counted in ``eigh.calls``. On CUDA it checks
    its errors on the host, which a CUDA-graph capture refuses: a route
    whose step runs it keeps the eager loop (``ops/graphs.py``)."""
    eigh.calls += 1
    return torch.linalg.eigh(cov)


eigh.calls = 0


def _eig_parts(cov):
    """(eigenvectors, clipped eigenvalues, nonzero mask) of a PSD matrix."""
    w, v = eigh(cov)
    w = torch.clamp(w, min=0.0)
    tol = _EIG_TOL * torch.clamp(torch.amax(w, dim=-1, keepdim=True), min=1.0)
    return v, w, w > tol


def _matvec(a, x):
    """a @ x over the trailing axes, broadcasting the batch axes."""
    return (a @ x[..., None])[..., 0]


@struct
class MvNormal:
    """N(mean, cov) over R^k: ``mean_`` (..., k), ``cov`` (..., k, k) PSD.
    With ``allow_singular`` (the default) the Cholesky and eigh paths are
    both computed and one is selected per matrix; without, the Cholesky
    path alone, for covariances known to be full rank."""

    mean_: torch.Tensor
    cov: torch.Tensor
    allow_singular: bool = True

    @property
    def event_dim(self) -> int:
        return self.cov.shape[-1]

    @property
    def batch_shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.mean_.shape[:-1], self.cov.shape[:-2])

    def _cholesky(self):
        """(L, ok): the Cholesky factor and, per matrix, whether it exists."""
        L, info = torch.linalg.cholesky_ex(self.cov)
        return L, (info == 0) & torch.all(torch.isfinite(L), dim=(-2, -1))

    def _cholesky_only(self):
        """The Cholesky factor, NaN where it does not exist."""
        L, ok = self._cholesky()
        return torch.where(ok[..., None, None], L, torch.nan)

    def _factor(self):
        """F with F Fᵀ = cov: Cholesky where it exists, else the eigen
        square root (columns v_i √w_i)."""
        if not self.allow_singular:
            return self._cholesky_only()
        L, ok = self._cholesky()
        v, w, _ = _eig_parts(self.cov)
        eig_sqrt = v * torch.sqrt(w)[..., None, :]
        return torch.where(ok[..., None, None], torch.nan_to_num(L), eig_sqrt)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape) + (self.event_dim,)
        eps = torch.randn(shape, generator=generator, device=self.cov.device,
                          dtype=self.cov.dtype)
        return self.mean_ + _matvec(self._factor(), eps)

    def log_prob(self, x):
        d = x - self.mean_
        k = self.event_dim
        eye = torch.eye(k, dtype=self.cov.dtype, device=self.cov.device)
        if not self.allow_singular:
            L = self._cholesky_only()
            L_inv = torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)
            z = _matvec(L_inv, d)
            logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
            return -0.5 * (k * _LOG_2PI + logdet + torch.sum(z * z, dim=-1))
        L, ok = self._cholesky()
        L_safe = torch.where(ok[..., None, None], torch.nan_to_num(L, nan=1.0), eye)
        L_inv = torch.linalg.solve_triangular(L_safe, eye.expand(L_safe.shape), upper=False)
        z = _matvec(L_inv, d)
        maha_c = torch.sum(z * z, dim=-1)
        logdet_c = 2.0 * torch.sum(
            torch.log(torch.abs(torch.diagonal(L_safe, dim1=-2, dim2=-1))), dim=-1)

        # singular path: Mahalanobis in the eigenbasis over the support
        v, w, nz = _eig_parts(self.cov)
        u = _matvec(v.mT, d)
        one = torch.ones_like(w)
        inv_w = torch.where(nz, 1.0 / torch.where(nz, w, one), 0.0)
        maha_e = torch.sum(u * u * inv_w, dim=-1)
        logdet_e = torch.sum(torch.where(nz, torch.log(torch.where(nz, w, one)), 0.0), dim=-1)
        rank = torch.sum(nz, dim=-1).to(self.cov.dtype)

        maha = torch.where(ok, maha_c, maha_e)
        logdet = torch.where(ok, logdet_c, logdet_e)
        dims = torch.where(ok, float(k), rank)
        return -0.5 * (dims * _LOG_2PI + logdet + maha)

    def in_support(self, x):
        return torch.all(torch.isfinite(x), dim=-1)

    def mean(self):
        return self.mean_.expand(tuple(self.batch_shape) + (self.event_dim,))
