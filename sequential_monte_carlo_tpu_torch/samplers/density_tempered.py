"""Density-tempered SMC (Duan & Fulop) — batch joint inference (L3),
counterpart of ``sequential_monte_carlo_tpu/samplers/density_tempered.py``:

  1. init — θ from the prior, one full-sequence batched filter for the log Ẑ
     of every θ, weights ω ∝ Ẑ;
  2. temper ξ → 1 — bisection (``SMCConfig.bisection_tol``, upper bound
     ``bisection_upper``) for the next ξ that pins the incremental-weight ESS
     at ``ess_min``; a corner solution ξ ≥ 1 is clamped to 1 with no move;
  3. at every other stage, the θ-resample and PMMH rejuvenation at temper ξ
     (``SMC2._resample_move``, the core SMC² shares).

The temper loop is on the host: a handful of stages, each reading the M log
Ẑ once for the bisection, in numpy float64. The filters and rejuvenations
run on the device.

Sharded (the JAX idiom: ``density_tempered(ShardedSMC2(sampler, mesh).sampler,
generator, y)``, a mesh in ``config.inner``): every rank runs this program in
lockstep, as SMC² does. The init's filters return this rank's rows of log Ẑ
(and its particles of each row); one all_gather makes log Ẑ whole before the
θ-weights, the ESS and the bisection read it, so every rank bisects the same
float64 numbers to the same ξ. The clouds stay the rank's part.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.batched_filter import batched_log_likelihood
from ..ops.weights import ess_from_log_weights
from ..utils.struct import replace
from .base import SMC2State
from .smc2 import SMC2


class TemperStage(NamedTuple):
    xi: float
    ess: float
    acc_ratio: float


def _np_normalize(logw: np.ndarray):
    """Normalized weights and their ESS, on the host in float64."""
    w = np.exp(logw - logw.max())
    w = w / w.sum()
    return w, 1.0 / np.sum(w**2)


def density_tempered(sampler: SMC2, generator, y, verbose: bool = False):
    """Run density-tempered SMC to ξ = 1 on the observations y (T,), on
    their device. Returns (state, [TemperStage, ...]); under a mesh the
    state's clouds are this rank's part and the rest is whole."""
    cfg = sampler.config
    T = y.shape[0]
    theta = sampler.prior.sample(generator, (cfg.n_theta,))
    particles, log_w, log_z = batched_log_likelihood(
        generator, sampler.model_fn(theta), cfg.n_particles, cfg.n_theta, y,
        cfg.inner)
    log_z = sampler._whole(log_z)
    state = SMC2State(
        theta=theta,
        log_omega=log_z,
        particles=particles,
        log_w=log_w,
        log_z=log_z,
        ess=ess_from_log_weights(log_z),
        acc_ratio=torch.zeros((), device=theta.device),
        t=T,
        active_n=cfg.n_particles,
        exchange_pending=False,
    )
    full_mask = torch.ones(T)
    trace = []
    xi = 0.0
    while xi < 1.0:
        old_xi = xi
        logz = state.log_z.double().cpu().numpy()  # host read, once a stage

        lower, upper = old_xi, cfg.bisection_upper
        new_xi = upper
        ess = float(state.ess)
        while upper - lower > cfg.bisection_tol:
            new_xi = (upper + lower) / 2.0
            _, ess = _np_normalize((new_xi - old_xi) * logz)
            if ess == cfg.ess_min:
                break
            if ess < cfg.ess_min:
                upper = new_xi
            else:
                lower = new_xi

        resample = new_xi < 1.0
        if not resample:  # corner solution
            new_xi = 1.0
            _, ess = _np_normalize((new_xi - old_xi) * logz)

        xi = new_xi
        log_omega = torch.as_tensor((new_xi - old_xi) * logz, dtype=torch.float32,
                                    device=theta.device)
        state = replace(state, log_omega=log_omega,
                        ess=torch.tensor(ess, dtype=torch.float32, device=theta.device))
        if resample:
            state = sampler._resample_move(generator, state, y, full_mask, xi)

        stage = TemperStage(xi=xi, ess=float(ess), acc_ratio=float(state.acc_ratio))
        trace.append(stage)
        if verbose:
            print(f"ξ = {stage.xi:.5f}\tess = {stage.ess:.3f}"
                  + (f"\t[rejuvenating]\tacc_rate: {stage.acc_ratio:.5f}" if resample else ""))
    return state, trace
