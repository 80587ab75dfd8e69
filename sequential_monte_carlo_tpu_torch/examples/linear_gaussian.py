"""Linear-Gaussian golden workflow — the reference README end to end; the
port's counterpart of ``examples/linear_gaussian_example.py``.

The univariate LG model ``lg_mod(θ) = LinearGaussian(θ₁, 1, θ₂, θ₃, 0)`` at
θ* = [0.5, 0.9, 0.8]: simulate T periods, run the bootstrap filter with
per-step quantiles and the full-sequence log-likelihood, then joint
inference with density-tempered SMC, online SMC² and IBIS under the
TruncatedNormal/LogNormal/LogNormal prior. It keeps that example's two
checks, and fails where they fail:

- the filter's log Ẑ against the exact Kalman log Z of the filter's own
  target (the filter draws x₁ ~ N(x0, Σ0), the Kalman filter predicts x₁
  from (x0', Σ0') with Σ0' = (Σ0 − Q)/A²): 16 filters, mean + var/2 within
  5 standard errors (the delta method);
- each sampler's posterior mean against the exact-IS oracle (50,000 prior
  draws weighted by the Kalman likelihood) within 0.3, the JAX tests'
  tolerance.

Run (on the card by default)::

  python -m sequential_monte_carlo_tpu_torch.examples.linear_gaussian [--m 256 --n 512]
"""
from __future__ import annotations

import argparse
import math

import torch

import sequential_monte_carlo_tpu_torch as smc
from sequential_monte_carlo_tpu_torch.analysis import weighted_quantile

THETA = (0.5, 0.9, 0.8)
POSTERIOR_TOL = 0.3
LOGZ_ROWS, LOGZ_SE = 16, 5.0


def lg_prior(device="cuda"):
    """The README's prior (README.md:74-85)."""
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return smc.product_distribution([
        smc.TruncatedNormal(f(0.0), f(1.0), f(-1.0), f(1.0)),
        smc.LogNormal(f(0.0), f(1.0)),
        smc.LogNormal(f(0.0), f(1.0)),
    ])


def check_posterior(name: str, mean, oracle) -> None:
    off = (mean - oracle).abs().max().item()
    print(f"{name:<15} θ̂ = {mean.cpu().numpy().round(4)} (max |θ̂ − oracle| {off:.4f})",
          flush=True)
    if off > POSTERIOR_TOL:
        raise AssertionError(f"{name}: posterior mean {mean.tolist()} off the exact-IS oracle "
                             f"{oracle.tolist()} by {off} > {POSTERIOR_TOL}")


def run(m: int = 256, n: int = 512, t: int = 100, device="cuda", seed: int = 1998) -> dict:
    """The workflow with its checks; returns its numbers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    theta_true = torch.tensor(THETA, device=device)
    model = smc.lg_model(theta_true)
    _, y = smc.simulate(gen, model, t)
    print(f"simulated T={t} with θ* = {list(THETA)}", flush=True)

    # -- bootstrap filter with per-step summaries (README.md:33-57)
    qs = (0.25, 0.5, 0.75)
    _, logz, series = smc.filter_sequence(
        gen, model, n, y,
        summarize=lambda s: weighted_quantile(s.particles[:, 0], torch.exp(s.log_weights), qs))
    print(f"bootstrap filter: logZ = {logz.item():.3f}; final ess = "
          f"{series['ess'][-1].item():.1f}", flush=True)

    # -- exact check: the Kalman log Z of the filter's own target
    a, q, r = THETA
    target = smc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2,
                                            device=device)
    kz = smc.kalman_log_likelihood(target, y)[1].item()
    lz = smc.batched_log_likelihood(gen, smc.broadcast_model(model, LOGZ_ROWS), n, LOGZ_ROWS,
                                    y)[2].double()
    mean, var = lz.mean().item(), lz.var().item()
    se = math.sqrt(var / LOGZ_ROWS + var**2 / (2 * (LOGZ_ROWS - 1)))
    print(f"exact Kalman logZ = {kz:.3f}; {LOGZ_ROWS} filters: mean + var/2 = "
          f"{mean + var / 2:.3f} (5 se {LOGZ_SE * se:.3f})", flush=True)
    if abs(mean + var / 2 - kz) > LOGZ_SE * se:
        raise AssertionError(f"filter log Z {mean} + {var / 2} vs Kalman {kz} beyond "
                             f"{LOGZ_SE}·{se}")

    # -- joint inference (README.md:74-104) against the exact-IS oracle
    prior = lg_prior(device)
    th = prior.sample(gen, (50_000,))
    w = torch.softmax(smc.kalman_log_likelihood(smc.lg_model(th), y)[1].double(), 0)
    oracle = (w @ th.double()).float()
    print(f"exact-IS oracle θ̄ = {oracle.cpu().numpy().round(4)}", flush=True)
    cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=3, ess_threshold=0.5)
    sampler = smc.SMC2(smc.lg_model, prior, cfg)
    dt_state, trace = smc.density_tempered(sampler, gen, y)
    print(f"density-tempered: {len(trace)} stages", flush=True)
    check_posterior("density-tempered", smc.expected_parameters(dt_state), oracle)
    smc2_state, infos = sampler.run(gen, y)
    print(f"online SMC²: ess {smc2_state.ess.item():.1f}, "
          f"{int(infos.rejuvenated.sum())} rejuvenations", flush=True)
    check_posterior("online SMC²", smc.expected_parameters(smc2_state), oracle)
    ibis_state, _ = smc.IBIS(smc.lg_model, prior, cfg).run(gen, y)
    check_posterior("IBIS (exact)", smc.expected_parameters(ibis_state), oracle)
    return {"logz": logz.item(), "kalman_logz": kz, "oracle": oracle,
            "dt": smc.expected_parameters(dt_state),
            "smc2": smc.expected_parameters(smc2_state),
            "ibis": smc.expected_parameters(ibis_state)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=256, help="θ-particles")
    p.add_argument("--n", type=int, default=512, help="state particles")
    p.add_argument("--t", type=int, default=100)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.m, args.n, args.t, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
