"""IBIS — SMC² with the exact Kalman inner filter (L3), counterpart of
``sequential_monte_carlo_tpu/samplers/ibis.py``: the resample-move-reweight
skeleton of SMC² with each θ's particle filter replaced by its exact Kalman
filter, so the per-θ state is a (mean, cov) pair and a rejuvenation re-runs
the exact masked log-likelihood. There is no exchange step (no N to double).
Linear-Gaussian models only.

The M Kalman filters are one batched bank (``ops/kalman.py``): a step is a
few (M, dx, dx) products. Like the port's SMC², a host loop with an explicit
``torch.Generator``; it runs no kernel. On the card, where
``batched_filter.captures`` admits the configuration (a mesh too), the step
after the rejuvenation decision is a CUDA-graph replay
(``ops/graphs.py::ibis_route``, the counterpart of the JAX package's
jitted scan): ``run`` keeps the state in the route's buffers, reads one
flag a step through a pinned buffer, runs a rejuvenation eagerly between
replays — the θ-resample, the RW proposals, ``model_fn`` and the accept,
each proposal's Kalman pass over y[0:t] replayed on its own route
(``ops/kalman.py::live_log_likelihood``), with no host read — and copies
the state out at the end; ``step`` loads the state, replays and returns a
state that owns its arrays. Inside ``disable_graphs()`` every step is the
eager loop, bit for bit the same.

θ-sharding (``config.inner.mesh``, ``parallel.ShardedIBIS``): as SMC²'s, θ,
log ω, log Z, the ESS and t are whole on every rank and the Kalman bank's
``mean`` and ``cov`` hold the rank's rows; the per-row log-likelihoods of a
step and of a rejuvenation's proposals are gathered whole, and a θ-resample
gathers the bank and keeps the ancestors' rows of this rank. On a mesh that
also shards particles the θ axis's group is the rank's particle column, and
the ranks of a particle group hold the same rows and compute the same bits:
the state is copied across them. On the card the mesh's steps replay too:
the online route's bank is the rank's rows and its step gathers their
log-likelihoods between two graphs (a cut, ``ops/graphs.py``); the Kalman
passes gather nothing and replay as without a mesh.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops import batched_filter as _bf
from ..ops import graphs
from ..ops.kalman import KalmanState, kalman_init, kalman_step, live_log_likelihood
from ..ops.resampling import get_resampler
from ..ops.sharding import all_gather_rows, local_model, local_rows, theta_rows
from ..ops.weights import ess_from_log_weights
from ..utils.struct import replace
from .base import IBISState, SMCConfig, StepInfo
from .kernels import anneal_scales, kernel_chol, propose, rw_kernel_cov
from .smc2 import expected_parameters  # re-exported for IBIS states too

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

    def _graphed(self, device) -> bool:
        """Whether the online steps and the rejuvenations' Kalman passes
        replay captured routes (``batched_filter.captures``: on the card,
        outside ``disable_graphs()``; on a mesh too)."""
        return _bf.captures(self.config.inner, None, device)

    def _rejuvenate(self, generator, state: IBISState, y, live: int) -> IBISState:
        """``chain`` PMMH moves with annealed RW proposals, each with the
        exact Kalman log-likelihood of all M proposals over y[0:live] (JAX's
        masked pass over the prefix)."""
        cfg = self.config
        m = cfg.n_theta
        theta, mean, cov, log_z = state.theta, state.mean, state.cov, state.log_z
        accepted = torch.zeros(m, dtype=torch.bool, device=theta.device)
        chol = kernel_chol(rw_kernel_cov(theta, cfg))
        graphed = self._graphed(theta.device)
        for scale in anneal_scales(cfg):
            theta_prop = propose(generator, theta, chol, scale)
            ok = self.prior.in_support(theta_prop)
            theta_safe = torch.where(ok[:, None], theta_prop, theta)
            (mean_prop, cov_prop), logz_prop = live_log_likelihood(
                self._models(theta_safe), y, live, graphed, cfg.inner.mesh)
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
                       # filled on the device: a tensor made from a host
                       # number there would wait for the device
                       ess=torch.full((), float(m), device=theta.device),
                       acc_ratio=torch.mean(accepted.to(theta.dtype)))

    @staticmethod
    def _owned(state: IBISState) -> IBISState:
        """The state with copies of the tensors that a later replay
        overwrites (views of the route's buffers)."""
        return replace(state, mean=state.mean.clone(), cov=state.cov.clone(),
                       log_omega=state.log_omega.clone(), log_z=state.log_z.clone(),
                       ess=state.ess.clone())

    def _online_step(self, generator, route, state: IBISState, y):
        """One online step on the captured route whose buffers hold
        ``state``: the host's one read (the flag ESS < ess_min of the step
        or load before), the rejuvenation eagerly where it is set, its result
        loaded into the buffers, then one replay. Returns (the state after
        it, its stepped tensors views of the route's buffers; whether it
        rejuvenated)."""
        degenerate = route.buffers.read_flag()
        if degenerate:
            state = self._rejuvenate(generator, self._resample_theta(generator, state), y,
                                     state.t)
            route.load(self._models(state.theta), state)
        route.replay(None, 1)
        return replace(state, t=state.t + 1, **route.buffers.fields(route.k)), degenerate

    def _step(self, generator, state: IBISState, y):
        """The eager step: (state, whether it rejuvenated, the evidence
        increment)."""
        cfg = self.config
        degenerate = bool(state.ess < cfg.ess_min)  # host sync
        if degenerate:
            state = self._rejuvenate(generator, self._resample_theta(generator, state), y,
                                     state.t)
        out = kalman_step(self._models(state.theta), KalmanState(state.mean, state.cov),
                          y[state.t])
        log_lik = all_gather_rows(out.log_lik, self._rows)
        prev_lse = torch.logsumexp(state.log_omega, dim=0)
        log_omega = state.log_omega + log_lik
        ess = ess_from_log_weights(log_omega)
        state = replace(state, mean=out.state.mean, cov=out.state.cov, log_omega=log_omega,
                        log_z=state.log_z + log_lik, ess=ess, t=state.t + 1)
        return state, degenerate, torch.logsumexp(log_omega, dim=0) - prev_lse

    def step(self, generator, state: IBISState, y):
        """One online step: rejuvenate over y[0:t] when the θ-ESS fell below
        ``ess_min``, then the exact Kalman update with y[t]. On a captured
        route (:meth:`_graphed`) the step after the decision is a graph
        replay, and the state returned owns its arrays. Returns (state,
        StepInfo)."""
        if self._graphed(state.theta.device):
            t = state.t
            route = graphs.ibis_route(self, state, y)
            state, degenerate = self._online_step(generator, route, state, y)
            state = self._owned(state)
            incr = route.buffers.infos(t, t + 1)["log_evidence_incr"][0]
        else:
            state, degenerate, incr = self._step(generator, state, y)
        return state, StepInfo(ess=state.ess, rejuvenated=torch.tensor(degenerate),
                               acc_ratio=state.acc_ratio, log_evidence_incr=incr)

    def run(self, generator, y):
        """Whole-sequence online IBIS: (final state, StepInfo stacked over
        the T − 1 steps; ``rejuvenated`` one tensor from the host's flags).
        On a captured route the state stays in its buffers between steps."""
        state = self.init(generator, y)
        fired = []
        if self._graphed(state.theta.device):
            route, first = graphs.ibis_route(self, state, y), state.t
            while state.t < y.shape[0]:
                state, degenerate = self._online_step(generator, route, state, y)
                fired.append(degenerate)
            state = self._owned(state)
            stores = route.buffers.infos(first, state.t)
            return state, StepInfo(ess=stores["ess"], rejuvenated=torch.tensor(fired),
                                   acc_ratio=stores["acc_ratio"],
                                   log_evidence_incr=stores["log_evidence_incr"])
        steps = []
        while state.t < y.shape[0]:
            state, degenerate, incr = self._step(generator, state, y)
            fired.append(degenerate)
            steps.append((state.ess, state.acc_ratio, incr))
        ess, acc_ratio, incr = (torch.stack(list(f)) for f in zip(*steps))
        return state, StepInfo(ess=ess, rejuvenated=torch.tensor(fired), acc_ratio=acc_ratio,
                               log_evidence_incr=incr)
