"""Online SMC² (Chopin, Jacob and Papaspiliopoulos, JRSS B 75(3), 2013) in
plain PyTorch: M θ rows, each with a bootstrap filter of N particles
(:mod:`.pf`), θ-weights multiplied by each step's likelihood estimate, and
when their ESS falls below ``ess_threshold``·M a multinomial θ-resample and
``chain`` particle-marginal Metropolis–Hastings moves, each refiltering the
observations seen so far. The moves are Gaussian random walks with the
θ-cloud's covariance times 2.83²/d (plus a jitter, or a floor where the
covariance has collapsed), scaled down over the chain by 0.5·(chain, …, 1):
the reference Julia package's defaults, which the pattern of
``benchmarks/baseline_numpy.py`` follows.

``dtype`` is that of every number except the proposal's Cholesky factor
(float32 at least; torch has none below it).
"""
from __future__ import annotations

import math

import torch

from . import pf

RW_SCALE = 2.83**2
COV_FLOOR_NORM, COV_FLOOR_VALUE, COV_JITTER = 1e-8, 1e-2, 1e-10
ANNEAL_BASE = 0.5


def _chol(theta):
    d = theta.shape[1]
    x = theta.to(torch.float32)
    c = x - x.mean(dim=0, keepdim=True)
    cov = (c.T @ c) / (x.shape[0] - 1)
    eye = torch.eye(d, device=x.device)
    if float(torch.linalg.norm(cov)) < COV_FLOOR_NORM:
        cov = COV_FLOOR_VALUE * eye
    else:
        cov = (RW_SCALE / d if d > 1 else RW_SCALE) * cov + COV_JITTER * eye
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where(info == 0, chol, torch.nan).tril()


def _rejuvenate(generator, model, prior, theta, cloud, log_w, log_z, y, n, chain):
    m = theta.shape[0]
    chol = _chol(theta)
    for k in range(chain, 0, -1):
        eps = torch.randn(theta.shape, generator=generator, device=theta.device,
                          dtype=torch.float32)
        prop = (theta.float() + math.sqrt(ANNEAL_BASE * k) * (eps @ chol.T)).to(theta.dtype)
        ok = prior.in_support(prop.float())
        safe = torch.where(ok[:, None], prop, theta)
        p_cloud, p_w, p_z = pf.run(generator, model, safe, y, n)
        log_ratio = (p_z - log_z).float() + prior.log_prob(prop.float()) - prior.log_prob(
            theta.float())
        log_u = torch.log(torch.rand(m, generator=generator, device=theta.device))
        accept = ok & torch.isfinite(p_z.float()) & (log_u < log_ratio)
        theta = torch.where(accept[:, None], prop, theta)
        cloud = torch.where(accept[:, None, None], p_cloud, cloud)
        log_w = torch.where(accept[:, None], p_w, log_w)
        log_z = torch.where(accept, p_z, log_z)
    return theta, cloud, log_w, log_z


def run(generator, model, prior, y, m: int, n: int, chain: int, ess_threshold: float,
        dtype=torch.float32) -> dict:
    """The whole run over y: the final θ, log ω, clouds' log-weights and
    log Z, the evidence estimate log p̂(y_2:T | y_1) (the sum of every step's
    log Σω_t − log Σω_t−1), and the steps t (observations seen) at which
    it rejuvenated."""
    y = y.to(dtype)
    theta = prior.sample(generator, m, y.device).to(dtype)
    cloud, log_w, log_z = pf.init(generator, model, theta, y[0], n)
    log_omega = log_z.clone()
    evidence = torch.zeros((), device=y.device, dtype=log_z.dtype)
    rejuvenated = []
    for t in range(1, y.shape[0]):
        omega = torch.softmax(log_omega.float(), dim=0)
        if float(1.0 / torch.sum(omega * omega)) < ess_threshold * m:
            a = torch.multinomial(omega, m, replacement=True, generator=generator)
            theta, cloud, log_w, log_z = theta[a], cloud[a], log_w[a], log_z[a]
            theta, cloud, log_w, log_z = _rejuvenate(generator, model, prior, theta, cloud,
                                                     log_w, log_z, y[:t], n, chain)
            log_omega = torch.zeros_like(log_omega)
            rejuvenated.append(t)
        cloud, log_w, log_z, incr = pf.step(generator, model, theta, cloud, log_w, log_z, y[t])
        prev = torch.logsumexp(log_omega, dim=0)
        log_omega = log_omega + incr
        evidence = evidence + (torch.logsumexp(log_omega, dim=0) - prev)
    return {"theta": theta, "log_omega": log_omega, "log_w": log_w, "log_z": log_z,
            "evidence": evidence, "rejuvenated": rejuvenated}
