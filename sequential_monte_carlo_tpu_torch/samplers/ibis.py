"""IBIS — SMC² with the exact Kalman inner filter (L3), counterpart of
``sequential_monte_carlo_tpu/samplers/ibis.py``: the resample-move-reweight
skeleton of SMC² with each θ's particle filter replaced by its exact Kalman
filter, so the per-θ state is a (mean, cov) pair and a rejuvenation re-runs
the exact masked log-likelihood. There is no exchange step (no N to double).
Linear-Gaussian models only.

The M Kalman filters are one batched bank (``ops/kalman.py``): a step is a
few (M, dx, dx) products. Like the port's SMC², a host loop with an explicit
``torch.Generator``; it runs no kernel.

θ-sharding (``config.inner.mesh``, ``parallel.ShardedIBIS``): as SMC²'s, θ,
log ω, log Z, the ESS and t are whole on every rank and the Kalman bank's
``mean`` and ``cov`` hold the rank's rows; the per-row log-likelihoods of a
step and of a rejuvenation's proposals are gathered whole, and a θ-resample
gathers the bank and keeps the ancestors' rows of this rank. On a mesh that
also shards particles the θ axis's group is the rank's particle column, and
the ranks of a particle group hold the same rows and compute the same bits:
the state is copied across them.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.kalman import KalmanState, kalman_init, kalman_log_likelihood_masked, kalman_step
from ..ops.resampling import get_resampler
from ..ops.sharding import all_gather_rows, local_model, local_rows, theta_rows
from ..ops.weights import ess_from_log_weights
from ..utils.struct import replace
from .base import IBISState, SMCConfig, StepInfo
from .kernels import anneal_scales, kernel_chol, propose, rw_kernel_cov
from .smc2 import _stack, expected_parameters  # re-exported for IBIS states too

__all__ = ["IBIS", "expected_parameters"]


class IBIS:
    """Iterated batch importance sampling over θ with exact marginals.

    Usage::

        ibis = IBIS(lg_model, prior, SMCConfig(n_theta=512, chain=3))
        gen = torch.Generator(device).manual_seed(0)
        state, infos = ibis.run(gen, y)
    """

    def __init__(self, model_fn: Callable, prior, config: SMCConfig = SMCConfig()):
        self.model_fn = model_fn
        self.prior = prior
        self.config = config
        # this rank's rows of the θ-bank under config.inner.mesh
        self._rows = theta_rows(config.inner.mesh, config.n_theta)

    def _models(self, theta: torch.Tensor):
        """This rank's rows of the θ-cloud's models."""
        return local_model(self.model_fn(theta), self._rows)

    def init(self, generator, y) -> IBISState:
        """θ from the prior; each θ's Kalman state updated with y[0]."""
        cfg = self.config
        theta = self.prior.sample(generator, (cfg.n_theta,))
        models = self._models(theta)
        out = kalman_step(models, kalman_init(models), y[0])
        ll = all_gather_rows(out.log_lik, self._rows)
        return IBISState(theta=theta, log_omega=ll, mean=out.state.mean, cov=out.state.cov,
                         log_z=ll, ess=ess_from_log_weights(ll),
                         acc_ratio=torch.zeros((), device=theta.device), t=1)

    def _resample_theta(self, generator, state: IBISState) -> IBISState:
        """Multinomial resample of θ, co-indexing the Kalman states and log Z."""
        w = torch.softmax(state.log_omega, dim=0)
        a = get_resampler(self.config.theta_resampling)(generator, w).long()
        mine = local_rows(a, self._rows)
        return replace(state, theta=state.theta[a],
                       mean=all_gather_rows(state.mean, self._rows)[mine],
                       cov=all_gather_rows(state.cov, self._rows)[mine],
                       log_z=state.log_z[a], log_omega=torch.zeros_like(state.log_omega))

    def _rejuvenate(self, generator, state: IBISState, y, mask) -> IBISState:
        """``chain`` PMMH moves with annealed RW proposals, each with the
        exact masked Kalman log-likelihood of all M proposals."""
        cfg = self.config
        m = cfg.n_theta
        theta, mean, cov, log_z = state.theta, state.mean, state.cov, state.log_z
        accepted = torch.zeros(m, dtype=torch.bool, device=theta.device)
        chol = kernel_chol(rw_kernel_cov(theta, cfg))
        for scale in anneal_scales(cfg):
            theta_prop = propose(generator, theta, chol, scale)
            ok = self.prior.in_support(theta_prop)
            theta_safe = torch.where(ok[:, None], theta_prop, theta)
            (mean_prop, cov_prop), logz_prop = kalman_log_likelihood_masked(
                self._models(theta_safe), y, mask)
            logz_prop = all_gather_rows(logz_prop, self._rows)
            lp_prop = self.prior.log_prob(theta_prop)
            lp_curr = self.prior.log_prob(theta)
            log_ratio = (logz_prop - log_z) + (lp_prop - lp_curr)
            guard = (logz_prop + lp_prop) > -torch.inf
            log_u = torch.log(torch.rand(m, generator=generator, device=theta.device))
            accept = ok & guard & (log_u < log_ratio)
            theta = torch.where(accept[:, None], theta_prop, theta)
            mine = local_rows(accept, self._rows)
            mean = torch.where(mine[:, None], mean_prop, mean)
            cov = torch.where(mine[:, None, None], cov_prop, cov)
            log_z = torch.where(accept, logz_prop, log_z)
            accepted = accepted | accept
        return replace(state, theta=theta, mean=mean, cov=cov, log_z=log_z,
                       log_omega=torch.zeros_like(state.log_omega),
                       ess=torch.tensor(float(m), device=theta.device),
                       acc_ratio=torch.mean(accepted.to(theta.dtype)))

    def step(self, generator, state: IBISState, y):
        """One online step: rejuvenate over y[0:t] when the θ-ESS fell below
        ``ess_min``, then the exact Kalman update with y[t]. Returns
        (state, StepInfo)."""
        cfg = self.config
        degenerate = bool(state.ess < cfg.ess_min)  # host sync
        if degenerate:
            mask = torch.arange(y.shape[0]) < state.t
            state = self._rejuvenate(generator, self._resample_theta(generator, state), y, mask)
        out = kalman_step(self._models(state.theta), KalmanState(state.mean, state.cov),
                          y[state.t])
        log_lik = all_gather_rows(out.log_lik, self._rows)
        prev_lse = torch.logsumexp(state.log_omega, dim=0)
        log_omega = state.log_omega + log_lik
        ess = ess_from_log_weights(log_omega)
        state = replace(state, mean=out.state.mean, cov=out.state.cov, log_omega=log_omega,
                        log_z=state.log_z + log_lik, ess=ess, t=state.t + 1)
        info = StepInfo(ess=ess, rejuvenated=torch.tensor(degenerate),
                        acc_ratio=state.acc_ratio,
                        log_evidence_incr=torch.logsumexp(log_omega, dim=0) - prev_lse)
        return state, info

    def run(self, generator, y):
        """Whole-sequence online IBIS: (final state, StepInfo stacked over
        the T − 1 steps)."""
        state = self.init(generator, y)
        infos = []
        for _ in range(y.shape[0] - 1):
            state, info = self.step(generator, state, y)
            infos.append(info)
        return state, _stack(infos)
