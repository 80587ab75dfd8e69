"""``SMC2.run`` over the configuration's series: an online posterior of M
θ rows, each with an inner filter of N particles, rejuvenated by ``chain``
PMMH moves whenever the θ-ESS falls below ``ess_threshold``·M. The
workload's ``sampler`` object holds the fields of the program's
``SMCConfig`` besides M, N and the inner filter (``inner``, the fields of
``PFConfig``); the reference reads ``chain`` and ``ess_threshold`` of it.

A call is one whole run from a fresh generator. Its inner steps are the
online steps (T − 1) and, for a rejuvenation after t observations, chain ×
(t − 1): what the program's ``StepInfo.rejuvenated`` says it did.

The check, after the window, with the program freed:
- ``evidence_gap``: the mean of the evidence estimate log p̂(y_2:T | y_1)
  (the sum of a call's ``log_evidence_incr``) over a sample of the calls,
  against its mean over ``reference_runs`` runs of the plain SMC²
  (:mod:`port_bench.reference.smc2`) on the same series and prior, in nats.
  It reads the inner filters' increments, the θ-weights and every
  rejuvenation.
- ``theta_distinct_gap``: |log| of the ratio of the number of distinct θ
  rows in the final cloud (averaged over the sampled calls) to the
  reference's. It reads the rejuvenation's moves: the θ-resample copies
  rows, and only the accepted PMMH moves part them again, so a move left
  out lets the cloud collapse onto the few prior draws that fit.
- ``posterior_mean_gap``: the widest gap of a coordinate's posterior mean
  (under the final θ-weights, averaged over the sampled calls) to the
  reference's, in the reference's posterior sds. It reads the θ-weights
  and the moves' acceptance: a ratio that leaves out the likelihood
  spreads the cloud back towards the prior.
- ``lse_err``: the widest |logsumexp| of a final inner row's log-weights
  over every call (0 where the rows are normalized).
Printed beside them: the evidence's spread over the calls, the posterior
means and sds of the calls and of the reference.
"""
from __future__ import annotations

import numpy as np

from port_bench.harness import catalog, seeds, series
from port_bench.reference import smc2 as ref_smc2
from port_bench.reference.priors import Prior

from . import _common


class Entry:
    def __init__(self, torch, smc, cell, seed: int, device: str, program: str = "program",
                 overrides=None):
        cfg, p = cell["config_data"], {**cell["params"], **(overrides or {})}
        self.torch, self.smc, self.seed, self.device = torch, smc, seed, device
        self.m, self.n, sampler = int(p["m"]), int(p["n"]), dict(p["sampler"])
        self.chain, self.ess_threshold = int(sampler["chain"]), float(sampler["ess_threshold"])
        self.check_calls, self.reference_runs = int(p["check_calls"]), int(p["reference_runs"])
        self.y = torch.tensor(series.make(cfg["series"], p.get("t")), device=device)
        self.t = int(self.y.shape[0])
        self.ref_model, self.ref_prior = catalog.load_module("reference/models", cfg["model"]), Prior(cfg["prior"])
        self.shape = {"rows": self.m, "particles": self.n, "planes": cfg["state_planes"],
                      "step_params": cfg["step_params"], "model": cfg["model"],
                      "carry": _common.carries(p["inner"])}
        self.sampler = None
        if program == "program":
            prior = _common.program_prior(torch, smc, cfg["prior"], device)
            self.sampler = smc.SMC2(getattr(smc, cfg["program_model"]), prior, smc.SMCConfig(
                n_particles=self.n, n_theta=self.m, inner=_common.pf_config(smc, p["inner"]),
                **sampler))
        else:
            self.dtype = _common.control_dtype(torch, cfg)
        self.evidence, self.post, self.lse, self.theta = [], [], [], []

    def _gen(self, seed: int):
        return self.torch.Generator(device=self.device).manual_seed(seed)

    def call(self, i: int):
        gen = self._gen(seeds.call_seed(self.seed, i))
        if self.sampler is not None:
            return self.sampler.run(gen, self.y)
        return ref_smc2.run(gen, self.ref_model, self.ref_prior, self.y, self.m, self.n,
                            self.chain, self.ess_threshold, self.dtype)

    def after(self, i: int, out, keep: bool = True) -> dict:
        torch = self.torch
        if self.sampler is not None:
            state, infos = out
            rejuv = (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist()
            theta, log_omega, log_w = state.theta, state.log_omega, state.log_w
            evidence = infos.log_evidence_incr.sum()
        else:
            rejuv, theta, log_omega, log_w = (out[k] for k in ("rejuvenated", "theta",
                                                                "log_omega", "log_w"))
            evidence = out["evidence"]
        steps = (self.t - 1) + self.chain * sum(t - 1 for t in rejuv)
        if keep:
            self.evidence.append(evidence.double())
            self.post.append(posterior(torch, theta, log_omega))
            self.theta.append(theta.clone())
            self.lse.append(torch.logsumexp(log_w.double(), dim=1).abs().max())
        return {"inner_steps": steps, "particle_steps": self.m * self.n * steps,
                "rejuvenations": len(rejuv)}

    def release(self) -> None:
        self.sampler = None
        if self.smc is not None:
            self.smc.clear_graphs()
        if self.device != "cpu":
            self.torch.cuda.empty_cache()

    def check(self) -> dict:
        torch = self.torch
        evidence = torch.stack(self.evidence).cpu().numpy()
        post = torch.stack(self.post).cpu().numpy()  # (calls, 2, d): means, sds
        lse = torch.stack(self.lse).cpu().numpy()
        ok = np.isfinite(evidence) & np.isfinite(post).all(axis=(1, 2)) & np.isfinite(lse)
        pick = _common.sample(self.seed, len(evidence), self.check_calls)
        gen = self._gen(seeds.stream_seed(self.seed, "reference"))
        refs = [ref_smc2.run(gen, self.ref_model, self.ref_prior, self.y, self.m, self.n,
                             self.chain, self.ess_threshold) for _ in range(self.reference_runs)]
        ref_ev = float(np.mean([float(r["evidence"]) for r in refs]))
        ref_mean, ref_sd = np.mean([posterior(torch, r["theta"], r["log_omega"]).cpu().numpy()
                                    for r in refs], axis=0)
        ev = evidence[pick]
        distinct = float(np.mean([distinct_rows(torch, self.theta[i]) for i in pick]))
        ref_distinct = float(np.mean([distinct_rows(torch, r["theta"]) for r in refs]))
        mean, sd = np.mean(post[pick], axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_gap = float(np.max(np.abs(mean - ref_mean) / ref_sd))
        return {"numbers": {"evidence_gap": abs(float(np.mean(ev)) - ref_ev),
                            "theta_distinct_gap": abs(float(np.log(distinct / ref_distinct))),
                            "posterior_mean_gap": mean_gap, "lse_err": float(np.max(lse))},
                "failed": int((~ok).sum()),
                "info": {"checked_calls": len(pick), "evidence_mean": float(np.mean(ev)),
                         "evidence_ref": ref_ev,
                         "evidence_sd": float(np.std(ev, ddof=1)) if len(ev) > 1 else None,
                         "posterior_mean": mean.tolist(), "posterior_mean_ref": ref_mean.tolist(),
                         "posterior_sd": sd.tolist(), "posterior_sd_ref": ref_sd.tolist(),
                         "theta_distinct": distinct, "theta_distinct_ref": ref_distinct,
                         "ref_rejuvenations": [len(r["rejuvenated"]) for r in refs]}}


def distinct_rows(torch, theta) -> int:
    return int(torch.unique(theta, dim=0).shape[0])


def posterior(torch, theta, log_omega):
    """(2, d): the mean and the sd of each coordinate of θ under the
    θ-weights softmax(log ω), in float64."""
    omega = torch.softmax(log_omega.double(), dim=0)
    theta = theta.double()
    mean = omega @ theta
    return torch.stack([mean, torch.sqrt(omega @ (theta - mean) ** 2)])
