#!/usr/bin/env python3
"""Reference numbers of the JAX package for ``chip_smoke.py``'s
density-tempered phase, computed on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_reference.py [--seeds 8] [--m 512] [--n 1024]

Runs ``density_tempered`` on the linear-Gaussian model at BASELINE config 4
(M=512, N=1024, T=100, chain=3, inner filter systematic at every step) with
the TruncatedNormal(0, 1, −1, 1) × LogNormal(0, 1)² prior, on the series
``chip_smoke.lg_series`` makes, over ``jax.random.key(0..seeds-1)``, and
prints the mean of the runs' posterior means and their standard deviation —
the ``DT_JAX_MEAN`` and ``DT_JAX_SD`` constants of ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import sequential_monte_carlo_tpu as smc  # noqa: E402
from chip_smoke import DT_CHAIN, DT_T, lg_series  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--n", type=int, default=1024)
    args = p.parse_args()
    prior = smc.product_distribution([
        smc.TruncatedNormal(jnp.asarray(0.0), jnp.asarray(1.0), jnp.asarray(-1.0),
                            jnp.asarray(1.0)),
        smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
        smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
    ])
    cfg = smc.SMCConfig(n_particles=args.n, n_theta=args.m, chain=DT_CHAIN,
                        ess_threshold=0.5, inner=smc.PFConfig("systematic", 1.0))
    sampler = smc.SMC2(smc.lg_model, prior, cfg)
    y = jnp.asarray(lg_series(DT_T))
    means = []
    for s in range(args.seeds):
        t0 = time.perf_counter()
        state, trace = smc.density_tempered(sampler, jax.random.key(s), y)
        means.append(np.asarray(smc.expected_parameters(state), np.float64))
        print(json.dumps({"seed": s, "seconds": round(time.perf_counter() - t0, 2),
                          "stages": [round(t.xi, 5) for t in trace],
                          "posterior_mean": means[-1].round(6).tolist()}), flush=True)
    means = np.asarray(means)
    print(json.dumps({"m": args.m, "n": args.n, "seeds": args.seeds,
                      "mean": means.mean(0).round(6).tolist(),
                      "sd": means.std(0, ddof=1).round(6).tolist()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
