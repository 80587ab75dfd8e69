"""The plain reference at tiny sizes: its filter against the exact Kalman
log Z, its SMC² end to end, its priors against closed forms."""
import math

import numpy as np
import torch

from port_bench.harness import series
from port_bench.reference import pf, smc2
from port_bench.reference.models import lg, ucsv
from port_bench.reference.priors import Prior

LG_PRIOR = [["truncated_normal", 0.0, 1.0, -1.0, 1.0], ["lognormal", 0.0, 1.0],
            ["lognormal", 0.0, 1.0]]


def test_filter_matches_kalman():
    y = torch.tensor(series.make({"kind": "lg_ar1", "seed": 1998, "t": 30,
                                  "theta": [0.5, 0.9, 0.8]}))
    theta = torch.tensor([[0.5, 0.9, 0.8], [0.9, 0.3, 1.5]]).repeat(32, 1)
    gen = torch.Generator().manual_seed(0)
    _, log_w, log_z = pf.run(gen, lg, theta, y, 2048)
    exact = lg.kalman_log_z(theta.numpy(), y.numpy())
    gap = (log_z.numpy() - exact).reshape(32, 2)
    se = gap.std(axis=0, ddof=1) / math.sqrt(32)
    assert np.all(np.abs(gap.mean(axis=0)) < 4 * se + 1e-3), (gap.mean(axis=0), se)
    assert torch.allclose(torch.logsumexp(log_w.double(), 1), torch.zeros(64, dtype=torch.float64),
                          atol=1e-5)


def test_ucsv_filter_and_bfloat16():
    y = torch.tensor(series.make({"kind": "random_walk_plus_noise", "seed": 1998, "t": 12,
                                  "level": 3.0, "walk_sd": 0.3, "noise_sd": 0.5}))
    theta = torch.tensor([[0.2, 3.0, 0.2, 0.3]]).repeat(4, 1)
    gen = torch.Generator().manual_seed(1)
    cloud, log_w, log_z = pf.run(gen, ucsv, theta, y, 512)
    assert cloud.shape == (4, 3, 512) and log_z.dtype == torch.float64
    assert torch.isfinite(log_z).all()
    _, log_w16, log_z16 = pf.run(gen, ucsv, theta.bfloat16(), y.bfloat16(), 512)
    assert log_z16.dtype == torch.bfloat16 and log_w16.dtype == torch.bfloat16
    # bfloat16's rows are normalized only to its own rounding
    assert torch.logsumexp(log_w16.double(), 1).abs().max() > 1e-4


def test_smc2_runs_and_rejuvenates():
    y = torch.tensor(series.make({"kind": "random_walk_plus_noise", "seed": 1998, "t": 20,
                                  "level": 3.0, "walk_sd": 0.3, "noise_sd": 0.5}))
    prior = Prior([["uniform", 0.0, 1.0], ["normal", 3.0, 2.0], ["uniform", 0.0, 2.0],
                   ["uniform", 0.0, 2.0]])
    out = smc2.run(torch.Generator().manual_seed(2), ucsv, prior, y, 32, 64, 2, 0.5)
    assert out["rejuvenated"] and math.isfinite(float(out["evidence"]))
    assert out["theta"].shape == (32, 4) and prior.in_support(out["theta"]).all()


def test_priors_closed_forms():
    prior = Prior(LG_PRIOR + [["uniform", -1.0, 3.0], ["normal", 1.0, 2.0]])
    theta = torch.tensor([[0.3, 1.0, math.e, 0.0, 1.0], [1.5, 1.0, 1.0, 0.0, 1.0]],
                         dtype=torch.float64)
    lp = prior.log_prob(theta)
    mass = math.erf(1 / math.sqrt(2))  # Φ(1) − Φ(−1)
    want = (-0.5 * 0.09 - 0.5 * math.log(2 * math.pi) - math.log(mass)
            - 0.5 * math.log(2 * math.pi)
            - 0.5 - 0.5 * math.log(2 * math.pi) - 1.0
            - math.log(4.0) - math.log(2.0) - 0.5 * math.log(2 * math.pi))
    assert math.isclose(float(lp[0]), want, rel_tol=1e-12)
    assert lp[1] == -math.inf  # A outside [−1, 1]
    draws = prior.sample(torch.Generator().manual_seed(3), 20000, "cpu", torch.float64)
    assert prior.in_support(draws).all()
    assert abs(float(draws[:, 3].mean()) - 1.0) < 0.05
    assert abs(float(draws[:, 4].std()) - 2.0) < 0.05
