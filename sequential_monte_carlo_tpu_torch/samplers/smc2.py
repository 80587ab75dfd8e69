"""SMC² — online joint state + parameter inference (L3), the port's subset
of ``sequential_monte_carlo_tpu/samplers/smc2.py``: ``init``, ``step`` and
``run`` with the exchange step off, the resample-move core that
density-tempered SMC shares, and ``expected_parameters``.

The M inner particle filters are one batched (M, N) program
(``ops/batched_filter.py``). Where the JAX package compiles the whole run
into one ``lax.scan`` with ``lax.cond`` triggers, the port is a host loop:
one ``step`` per observation, which reads the θ-ESS on the host to decide on
a rejuvenation, and rejuvenations that loop over the consumed prefix
y[0:t] only. Randomness comes from one explicit ``torch.Generator`` on the
device of the data.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.batched_filter import (
    as_cloud,
    batched_log_likelihood_masked,
    batched_pf_init,
    batched_pf_step,
    from_cloud,
)
from ..ops.resampling import get_resampler
from ..ops.weights import ess_from_log_weights
from ..utils.struct import replace
from .base import SMC2State, SMCConfig, StepInfo
from .kernels import anneal_scales, kernel_chol, propose, rw_kernel_cov


def expected_parameters(state) -> torch.Tensor:
    """ω-weighted posterior mean of θ."""
    return torch.softmax(state.log_omega, dim=0) @ state.theta


class SMC2:
    """Online SMC² sampler.

    Parameters
    ----------
    model_fn : θ (M, dθ) → batched model (e.g. ``ucsv_model``).
    prior : distribution over θ with sample/log_prob/in_support.
    config : SMCConfig.

    Usage::

        sampler = SMC2(ucsv_model, prior, SMCConfig(1024, 512, 5, 0.5))
        gen = torch.Generator(device).manual_seed(0)
        state, infos = sampler.run(gen, y)   # y on the device
    """

    def __init__(self, model_fn: Callable, prior,
                 config: SMCConfig = SMCConfig()):
        if config.acc_threshold > 0.0:
            raise NotImplementedError(
                "the exchange step (acc_threshold > 0) comes with ROADMAP "
                "Queue 1 item 8"
            )
        self.model_fn = model_fn
        self.prior = prior
        self.config = config

    def init(self, generator, y) -> SMC2State:
        """Draw the θ-cloud from the prior and assimilate y[0] for every θ."""
        cfg = self.config
        theta = self.prior.sample(generator, (cfg.n_theta,))
        outs = batched_pf_init(generator, self.model_fn(theta),
                               cfg.n_particles, cfg.n_theta, y[0], cfg.inner)
        return SMC2State(
            theta=theta,
            log_omega=outs.log_mean,
            particles=outs.particles,
            log_w=outs.log_weights,
            log_z=outs.log_mean,
            ess=ess_from_log_weights(outs.log_mean),
            acc_ratio=torch.zeros((), device=theta.device),
            t=1,
        )

    def _resample_theta(self, generator, state: SMC2State) -> SMC2State:
        """Multinomial resample of the θ-particles, co-indexing their clouds
        and running log Z."""
        w = torch.softmax(state.log_omega, dim=0)
        a = get_resampler(self.config.theta_resampling)(generator, w).long()
        return replace(
            state,
            theta=state.theta[a],
            particles=from_cloud(as_cloud(state.particles)[a]),
            log_w=state.log_w[a],
            log_z=state.log_z[a],
            log_omega=torch.zeros_like(state.log_omega),
        )

    def _rejuvenate(self, generator, state: SMC2State, y, mask,
                    xi: float = 1.0) -> SMC2State:
        """``chain`` PMMH moves with annealed RW proposals; each re-runs the
        inner filter over the masked history for all M proposals at once."""
        cfg = self.config
        m, n = cfg.n_theta, state.particles.shape[1]
        theta, log_z = state.theta, state.log_z
        cloud, log_w = as_cloud(state.particles), state.log_w
        accepted = torch.zeros(m, dtype=torch.bool, device=theta.device)
        chol = kernel_chol(rw_kernel_cov(theta, cfg))
        for scale in anneal_scales(cfg):
            theta_prop = propose(generator, theta, chol, scale)
            ok = self.prior.in_support(theta_prop)
            # run the filter at a safe θ where the proposal left the support
            # (its result is discarded by the accept select)
            theta_safe = torch.where(ok[:, None], theta_prop, theta)
            new_p, new_lw, logz_prop = batched_log_likelihood_masked(
                generator, self.model_fn(theta_safe), n, m, y, mask, cfg.inner
            )
            lp_prop = self.prior.log_prob(theta_prop)
            lp_curr = self.prior.log_prob(theta)
            log_ratio = xi * (logz_prop - log_z) + (lp_prop - lp_curr)
            guard = (logz_prop + lp_prop) > -torch.inf
            log_u = torch.log(torch.rand(m, generator=generator,
                                         device=theta.device))
            accept = ok & guard & (log_u < log_ratio)
            theta = torch.where(accept[:, None], theta_prop, theta)
            cloud = torch.where(accept[:, None, None], as_cloud(new_p), cloud)
            log_w = torch.where(accept[:, None], new_lw, log_w)
            log_z = torch.where(accept, logz_prop, log_z)
            accepted = accepted | accept
        return replace(
            state,
            theta=theta,
            particles=from_cloud(cloud),
            log_w=log_w,
            log_z=log_z,
            log_omega=torch.zeros_like(state.log_omega),
            ess=torch.tensor(float(m), device=theta.device),
            acc_ratio=torch.mean(accepted.to(theta.dtype)),
        )

    def _resample_move(self, generator, state: SMC2State, y, mask,
                       xi: float = 1.0) -> SMC2State:
        """θ-resample followed by tempered rejuvenation — the resample-move
        core shared by SMC² (ξ = 1) and density-tempered SMC."""
        state = self._resample_theta(generator, state)
        return self._rejuvenate(generator, state, y, mask, xi)

    def step(self, generator, state: SMC2State, y):
        """One online assimilation step of y[state.t]; rejuvenates first
        when the θ-ESS fell below ``ess_min``. Returns (state, StepInfo)."""
        cfg = self.config
        degenerate = bool(state.ess < cfg.ess_min)  # host sync
        if degenerate:
            mask = torch.arange(y.shape[0]) < state.t
            state = self._resample_move(generator, state, y, mask)

        outs = batched_pf_step(generator, self.model_fn(state.theta),
                               state.particles, state.log_w, y[state.t],
                               cfg.inner)
        prev_lse = torch.logsumexp(state.log_omega, dim=0)
        log_omega = state.log_omega + outs.log_mean
        ess = ess_from_log_weights(log_omega)
        state = replace(
            state,
            log_omega=log_omega,
            particles=outs.particles,
            log_w=outs.log_weights,
            log_z=state.log_z + outs.log_mean,
            ess=ess,
            t=state.t + 1,
        )
        info = StepInfo(
            ess=ess,
            rejuvenated=torch.tensor(degenerate),
            acc_ratio=state.acc_ratio,
            log_evidence_incr=torch.logsumexp(log_omega, dim=0) - prev_lse,
        )
        return state, info

    def run(self, generator, y):
        """Whole-sequence online run: ``init`` then ``step`` over y[1:].
        Returns (final state, StepInfo of per-step tensors stacked over the
        T − 1 steps)."""
        state = self.init(generator, y)
        infos = []
        for _ in range(y.shape[0] - 1):
            state, info = self.step(generator, state, y)
            infos.append(info)
        return state, StepInfo(*(torch.stack(f) for f in zip(*infos)))
