"""Faults planted under the timed path, to see the check fail: the
benchmark's CPU tests plant each in a whole run, and ``calibrate.py
--fault`` reads one on the card at a cell's own size.

Where the inner step's propagate returns (the models'
``fused_propagate_reweight``, which every inner step of both cells calls):
- ``unchanged``: the step returns its state unchanged;
- ``half``: half of the particles are left out and the normalize takes the
  mean over the rest;
- ``answer``: one row's answer (its evidence increment) is altered where it
  is produced.
In SMC²'s rejuvenation (``SMC2._rejuvenate``, eager between the replays):
- ``move_unchanged``: the PMMH moves return θ unchanged (the θ-resample
  stays);
- ``move_prior``: the acceptance ratio leaves out the likelihood (the moves
  target the prior).
The cells run on one card, so no exchange between cards can be left out.
"""
from __future__ import annotations

import math
from dataclasses import replace


def _unchanged(orig):
    def step(self, y, cloud, *args, **kw):
        res = orig(self, y, cloud, *args, **kw)
        res[0].copy_(cloud)
        return res
    return step


def _half(orig):
    def step(self, y, cloud, *args, **kw):
        new, log_norm, lse, ess = orig(self, y, cloud, *args, **kw)
        raw = log_norm + lse
        kept = raw[:, : raw.shape[1] // 2].logsumexp(dim=1, keepdim=True)
        log_norm.copy_(raw - kept)
        lse.copy_(kept + math.log(2.0))
        return new, log_norm, lse, ess
    return step


def _answer(orig):
    def step(self, y, cloud, *args, **kw):
        new, log_norm, lse, ess = orig(self, y, cloud, *args, **kw)
        lse[0] += 0.5
        return new, log_norm, lse, ess
    return step


def _move_unchanged(orig):
    def rejuvenate(self, generator, state, y, mask, xi=1.0):
        return replace(state, log_omega=state.log_omega.new_zeros(state.log_omega.shape),
                       ess=state.log_omega.new_full((), float(self.config.n_theta)),
                       acc_ratio=state.log_omega.new_zeros(()))
    return rejuvenate


def _move_prior(orig):
    def rejuvenate(self, generator, state, y, mask, xi=1.0):
        return orig(self, generator, state, y, mask, 0.0)
    return rejuvenate


INNER = {"unchanged": _unchanged, "half": _half, "answer": _answer}
SAMPLER = {"move_unchanged": _move_unchanged, "move_prior": _move_prior}
NAMES = tuple(INNER) + tuple(SAMPLER)


def plant(smc, name: str, set_attr=setattr) -> None:
    """Plant fault ``name`` in the program ``smc`` through ``set_attr``
    (pytest's ``monkeypatch.setattr`` undoes it after a test)."""
    if name in INNER:
        for cls in (smc.models.ucsv.UCSVModel, smc.models.linear_gaussian.LinearGaussianModel):
            set_attr(cls, "fused_propagate_reweight", INNER[name](cls.fused_propagate_reweight))
    else:
        cls = smc.samplers.smc2.SMC2
        set_attr(cls, "_rejuvenate", SAMPLER[name](cls._rejuvenate))
