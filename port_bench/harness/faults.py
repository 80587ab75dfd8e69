"""Faults planted under the timed path, to see the check fail: the
benchmark's CPU tests plant each in a whole run, and ``calibrate.py
--fault`` reads one on the card at a cell's own size.

On the outputs of the batched filter's step (``ops/batched_filter.py``:
``_pf_step_from_draws``, the bootstrap and guided step of every model,
and ``_apf_step_from_draws``, the auxiliary filter's), which every inner
step of every cell runs through, eager or captured in a route's graph:
- ``unchanged``: the step returns its particles as they came (the cloud
  never moves);
- ``half``: half of the particles are left out, and the normalize and the
  evidence increment take the mean over the rest;
- ``answer``: one row's answer (its evidence increment) is altered where it
  is produced.
Where the step writes into a route's buffers (``out``), the fault writes
there too, in place, so that a graph captured after the plant holds it. A
route captured before the plant replays what it captured: plant one fault
a process, or clear the program's graphs (``clear_graphs``) first.
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
    def step(u, draws, models, particles, log_w, *args, **kw):
        out = orig(u, draws, models, particles, log_w, *args, **kw)
        out.particles.copy_(particles)
        return out
    return step


def _half(orig):
    def step(*args, **kw):
        out = orig(*args, **kw)
        log_w = out.log_weights  # normalized a row
        kept = log_w[:, : log_w.shape[1] // 2].logsumexp(dim=1)
        log_w.sub_(kept[:, None])
        return out._replace(log_mean=out.log_mean + kept + math.log(2.0))
    return step


def _answer(orig):
    def step(*args, **kw):
        out = orig(*args, **kw)
        log_mean = out.log_mean.clone()
        log_mean[0] += 0.5  # a device add: no host copy inside a capture
        return out._replace(log_mean=log_mean)
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
STEPS = ("_pf_step_from_draws", "_apf_step_from_draws")  # in ops/batched_filter.py


def plant(smc, name: str, set_attr=setattr) -> None:
    """Plant fault ``name`` in the program ``smc`` through ``set_attr``
    (pytest's ``monkeypatch.setattr`` undoes it after a test)."""
    if name in INNER:
        module = smc.ops.batched_filter
        for step in STEPS:
            set_attr(module, step, INNER[name](getattr(module, step)))
    else:
        cls = smc.samplers.smc2.SMC2
        set_attr(cls, "_rejuvenate", SAMPLER[name](cls._rejuvenate))
