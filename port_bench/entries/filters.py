"""``batched_log_likelihood``: a bank of M filters of N particles over the
configuration's series, one θ row each, the rows drawn by the benchmark
from the configuration's prior.

Set-up draws ``theta_banks`` banks of M rows from the seed on the device
(the reference's prior sampler); call i filters bank i mod ``theta_banks``
from a fresh generator. A call's inner steps are T − 1.

The check, after the window, with the program freed:
- ``logz_gap``: for the rows of a sample of the calls, the mean gap between
  the program's log Ẑ and that of the plain bootstrap filter
  (:mod:`port_bench.reference.pf`) at the same θ, N and series, in nats.
  Both are unbiased for Z at every row, so the gaps centre on 0 whatever θ
  is. Rows whose reference filter collapses, by its own estimate of its
  log Ẑ's variance (above ``max_ref_var`` nats²: θ drawn far in the prior's
  tails, where a few particles carry the weights and either filter's log Ẑ
  is off by up to tens of nats), are left out.
- ``lse_err``: the widest |logsumexp| of a final row's log-weights over
  every call (0 where the rows are normalized).
Printed beside them: the gaps' spread over the rows, and the reference
filter's mean gap to the exact Kalman log Z.
"""
from __future__ import annotations

import numpy as np

from port_bench.harness import catalog, seeds, series
from port_bench.reference import pf
from port_bench.reference.priors import Prior

from . import _common


class Entry:
    def __init__(self, torch, smc, cell, seed: int, device: str, program: str = "program",
                 overrides=None):
        cfg, p = cell["config_data"], {**cell["params"], **(overrides or {})}
        self.torch, self.smc, self.seed, self.device = torch, smc, seed, device
        self.m, self.n, self.banks = int(p["m"]), int(p["n"]), int(p["theta_banks"])
        self.check_calls, self.max_ref_var = int(p["check_calls"]), float(p["max_ref_var"])
        self.y = torch.tensor(series.make(cfg["series"], p.get("t")), device=device)
        self.t = int(self.y.shape[0])
        self.ref_model, self.ref_prior = catalog.load_module("reference/models", cfg["model"]), Prior(cfg["prior"])
        gen = torch.Generator(device=device).manual_seed(seeds.stream_seed(seed, "inputs"))
        self.pool = self.ref_prior.sample(gen, self.banks * self.m, device).view(
            self.banks, self.m, self.ref_prior.dim)
        self.shape = {"rows": self.m, "particles": self.n, "planes": cfg["state_planes"],
                      "step_params": cfg["step_params"], "model": cfg["model"],
                      "carry": _common.carries(p["inner"])}
        self.live = program == "program"
        if self.live:
            self.model_fn = getattr(smc, cfg["program_model"])
            self.inner = _common.pf_config(smc, p["inner"])
        else:
            self.dtype = _common.control_dtype(torch, cfg)
        self.log_z, self.lse, self.bank_of = [], [], []

    def _gen(self, seed: int):
        return self.torch.Generator(device=self.device).manual_seed(seed)

    def call(self, i: int):
        gen, theta = self._gen(seeds.call_seed(self.seed, i)), self.pool[i % self.banks]
        if self.live:
            return self.smc.batched_log_likelihood(gen, self.model_fn(theta), self.n, self.m,
                                                   self.y, self.inner)
        return pf.run(gen, self.ref_model, theta.to(self.dtype), self.y.to(self.dtype), self.n)

    def after(self, i: int, out, keep: bool = True) -> dict:
        if keep:
            _, log_w, log_z = out
            self.log_z.append(log_z.double())
            self.lse.append(self.torch.logsumexp(log_w.double(), dim=1).abs().max())
            self.bank_of.append(i % self.banks)
        steps = self.t - 1
        return {"inner_steps": steps, "particle_steps": self.m * self.n * steps}

    def release(self) -> None:
        self.live = False
        if self.smc is not None:
            self.smc.clear_graphs()
        if self.device != "cpu":
            self.torch.cuda.empty_cache()

    def check(self) -> dict:
        torch = self.torch
        log_z = torch.stack(self.log_z).cpu().numpy()
        lse = torch.stack(self.lse).cpu().numpy()
        ok = np.isfinite(log_z).all(axis=1) & np.isfinite(lse)
        gen = self._gen(seeds.stream_seed(self.seed, "reference"))
        gaps, var, kalman = [], [], []
        for pos in _common.sample(self.seed, len(log_z), self.check_calls):
            theta = self.pool[self.bank_of[pos]]
            _, _, ref, v = pf.run(gen, self.ref_model, theta, self.y, self.n, variance=True)
            ref = ref.cpu().numpy()
            gaps.append(log_z[pos] - ref)
            var.append(v.cpu().numpy())
            if hasattr(self.ref_model, "kalman_log_z"):
                kalman.append(ref - self.ref_model.kalman_log_z(theta.cpu().numpy(),
                                                                self.y.cpu().numpy()))
        gaps, var = np.concatenate(gaps), np.concatenate(var)
        kept = gaps[var <= self.max_ref_var]
        return {"numbers": {"logz_gap": abs(float(np.mean(kept))),
                            "lse_err": float(np.max(lse))},
                "failed": int((~ok).sum()),
                "info": {"checked_rows": len(gaps), "rows_left_out": int(len(gaps) - len(kept)),
                         "logz_gap_all_rows": abs(float(np.mean(gaps))),
                         "logz_gap_sd": float(np.std(kept, ddof=1)),
                         "ref_minus_kalman_mean": float(np.mean(np.concatenate(kalman)))
                         if kalman else None}}
