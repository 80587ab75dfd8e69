#!/usr/bin/env python3
"""Reference numbers of the JAX package for ``chip_smoke.py``'s posterior
checks, computed on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_reference.py
        [--run dt|apf_ucsv|apf_lg|ucsv_bank|pg_ucsv|ffbs_ucsv|pg_lg|inflation_uc|
               inflation_ucsv|ucsv_animation] [--seeds 8]
        [--m 512] [--n 1024]

Each sampler run repeats one sampler over ``jax.random.key(0..seeds-1)`` and
prints the mean of the runs' posterior means and their standard deviation:

- ``dt``: ``density_tempered`` on the linear-Gaussian model at BASELINE
  config 4 (M=512, N=1024, T=100, chain=3, inner filter systematic at every
  step) with the TruncatedNormal(0, 1, −1, 1) × LogNormal(0, 1)² prior, on
  the series ``chip_smoke.lg_series`` makes — ``DT_JAX_MEAN``/``DT_JAX_SD``;
- ``apf_ucsv``: online SMC² on UC-SV with the auxiliary particle filter
  inside (``PFConfig("systematic", 1.0, algorithm="apf")``) at bench.py's
  configuration (M=512, N=1024, T=241, chain=5) with bench.py's prior, on
  ``chip_smoke.ucsv_series`` — ``APF_JAX_MEAN``/``APF_JAX_SD``;
- ``apf_lg``: the README's APF SMC² on the linear-Gaussian model (M=512,
  N=1024, chain=3) with the ``dt`` run's prior and series —
  ``APF_LG_JAX_MEAN``/``APF_LG_JAX_SD``.

- ``inflation_uc``: the inflation example's online SMC² on the UC model
  (``examples/inflation_example.py``: M=512, N=1024, chain=3,
  ``ess_threshold`` 0.5, its ``uc_prior``, the vendored PCE series
  ``examples/data/pce_inflation.csv``) — ``INFLATION_UC_JAX_MEAN``/``_SD``;
- ``inflation_ucsv``: the same on UC-SV with chain=5 and ``ucsv_prior``, at
  N=1024 (the example's N is 8192; SMC² with PMMH moves targets the same
  posterior at every N) — ``INFLATION_UCSV_JAX_MEAN``/``_SD``.

``ucsv_bank`` runs M parallel UC-SV filters at θ = ``chip_smoke.JAX_MEAN``
on ``chip_smoke.ucsv_series`` (N=1024, T=241), bootstrap and APF, over the
same keys, and prints per filter the pooled mean and variance of log Ẑ
over seeds·M rows — ``UCSV_BANK_JAX``.

``pg_ucsv`` runs ``particle_gibbs`` on UC-SV at
``benchmarks/bench_pg.py``'s configuration (T=241, N=8192, 50 sweeps,
chain=3, bench.py's prior, ``chip_smoke.ucsv_series``), methods "bs" and
"as", over the keys, and prints per method the mean and standard deviation
of the runs' θ-chain means after ``chip_smoke.PG_BURN`` sweeps, and their
mean acceptance — ``PG_JAX``. ``ffbs_ucsv`` runs ``smoothed_marginals`` on
UC-SV at θ = ``chip_smoke.JAX_MEAN`` (N=8192, the blocked backward pass) on
``chip_smoke.ucsv_series`` over the keys, and prints the mean and standard
deviation over the runs of the smoothed means averaged over
``chip_smoke.window_means``' windows, and the mean and variance of the
forward filter's log Ẑ — ``FFBS_JAX``. ``pg_lg`` runs ``particle_gibbs``
on the linear-Gaussian model at ``tests/test_particle_gibbs.py``'s
configuration (N=128, 400 sweeps, chain=3, the ``dt`` run's prior) on
``chip_smoke.lg_series(60)``, and prints each run's θ-chain mean after 150
sweeps, their spread over the seeds and the prior-IS oracle (100,000 prior
draws weighted by the Kalman likelihood). None of the three takes
``--m``/``--n``.

``ucsv_animation`` runs ``examples/ucsv_animation.py``'s filter (the
bootstrap filter on UC-SV at its ``THETA_HAT``, N=4096, the vendored PCE
series read by its ``load_pce``) through ``filter_sequence`` with
``fused_resample="off"`` over the keys, and prints the mean and variance of
log Ẑ over the seeds — ``ANIMATION_UCSV_JAX``. It takes ``--n`` (default
4096 here).
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
from chip_smoke import (  # noqa: E402
    CHAIN,
    DT_CHAIN,
    DT_T,
    FFBS_N,
    JAX_MEAN,
    PG_BURN,
    PG_CHAIN,
    PG_LG_BURN,
    PG_LG_N,
    PG_LG_SWEEPS,
    PG_LG_T,
    PG_N,
    PG_SWEEPS,
    T,
    lg_series,
    ucsv_series,
    window_means,
)
from sequential_monte_carlo_tpu.ops.batched_filter import batched_log_likelihood  # noqa: E402


def _lg_prior():
    f = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    return smc.product_distribution([
        smc.TruncatedNormal(f(0.0), f(1.0), f(-1.0), f(1.0)),
        smc.LogNormal(f(0.0), f(1.0)),
        smc.LogNormal(f(0.0), f(1.0)),
    ])


def _ucsv_prior():  # bench.py:105-112
    f = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    return smc.product_distribution([
        smc.Uniform(f(0.0), f(1.0)), smc.Normal(f(3.0), f(2.0)),
        smc.Uniform(f(0.0), f(2.0)), smc.Uniform(f(0.0), f(2.0)),
    ])


def _runner(name: str, m: int, n: int):
    """(run(key) -> (state, stage or step summary), the series)."""
    if name == "dt":
        cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=DT_CHAIN, ess_threshold=0.5,
                            inner=smc.PFConfig("systematic", 1.0))
        sampler = smc.SMC2(smc.lg_model, _lg_prior(), cfg)
        y = jnp.asarray(lg_series(DT_T))

        def run(key):
            state, trace = smc.density_tempered(sampler, key, y)
            return state, {"stages": [round(t.xi, 5) for t in trace]}
        return run
    apf = smc.PFConfig("systematic", 1.0, algorithm="apf")
    if name == "apf_ucsv":
        cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=CHAIN, ess_threshold=0.5, inner=apf)
        sampler = smc.SMC2(smc.ucsv_model, _ucsv_prior(), cfg)
        y = jnp.asarray(ucsv_series(T))
    elif name == "apf_lg":
        cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=DT_CHAIN, ess_threshold=0.5,
                            inner=apf)
        sampler = smc.SMC2(smc.lg_model, _lg_prior(), cfg)
        y = jnp.asarray(lg_series(DT_T))
    elif name in ("inflation_uc", "inflation_ucsv"):
        from examples.inflation_example import load_pce, uc_prior, ucsv_prior

        uc = name == "inflation_uc"
        cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=3 if uc else 5, ess_threshold=0.5)
        sampler = smc.SMC2(smc.uc_model if uc else smc.ucsv_model,
                           uc_prior() if uc else ucsv_prior(), cfg)
        y = load_pce()[1]
    else:
        raise SystemExit(f"unknown run {name!r}")

    def run(key):
        state, infos = sampler.run(key, y)
        return state, {"rejuvenations": int(np.asarray(infos.rejuvenated).sum()),
                       "ess": float(state.ess)}
    return run


def ucsv_bank(seeds: int, m: int, n: int) -> None:
    """log Ẑ of m UC-SV filters at θ = JAX_MEAN, bootstrap and APF, pooled
    over seeds·m rows."""
    models = jax.vmap(smc.ucsv_model)(jnp.broadcast_to(jnp.asarray(JAX_MEAN, jnp.float32), (m, 4)))
    y = jnp.asarray(ucsv_series(T))
    for alg in ("bootstrap", "apf"):
        cfg = smc.PFConfig("systematic", 1.0, algorithm=alg)
        rows = []
        for s in range(seeds):
            t0 = time.perf_counter()
            lz = np.asarray(batched_log_likelihood(jax.random.key(s), models, n, m, y, cfg)[-1],
                            np.float64)
            rows.append(lz)
            print(json.dumps({"run": "ucsv_bank", "algorithm": alg, "seed": s,
                              "seconds": round(time.perf_counter() - t0, 2),
                              "logz_mean": round(lz.mean(), 6),
                              "logz_var": round(lz.var(ddof=1), 6)}), flush=True)
        lz = np.concatenate(rows)
        print(json.dumps({"run": "ucsv_bank", "algorithm": alg, "m": m, "n": n, "T": T,
                          "rows": lz.size, "logz_mean": round(lz.mean(), 6),
                          "logz_var": round(lz.var(ddof=1), 6)}), flush=True)


def ucsv_animation(seeds: int, n: int) -> None:
    """log Ẑ of the UC-SV animation's filter at THETA_HAT, over the seeds."""
    from examples.ucsv_animation import THETA_HAT, load_pce

    _, y = load_pce()
    model = smc.ucsv_model(jnp.asarray(THETA_HAT, jnp.float32))
    cfg = smc.PFConfig("systematic", 1.0, "off")
    rows = []
    for s in range(seeds):
        t0 = time.perf_counter()
        rows.append(float(smc.filter_sequence(jax.random.key(s), model, n, y, cfg)[1]))
        print(json.dumps({"run": "ucsv_animation", "seed": s, "log_z": round(rows[-1], 6),
                          "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    lz = np.asarray(rows, np.float64)
    print(json.dumps({"run": "ucsv_animation", "n": n, "T": int(y.shape[0]), "seeds": seeds,
                      "logz_mean": round(lz.mean(), 6), "logz_var": round(lz.var(ddof=1), 6)}),
          flush=True)


def _report(key: str, rows: list) -> dict:
    """Mean and standard deviation over the seeds of each row's ``key``."""
    vals = np.asarray([r[key] for r in rows], np.float64)
    return {f"{key}_mean": vals.mean(0).round(6).tolist(),
            f"{key}_sd": vals.std(0, ddof=1).round(6).tolist()}


def pg_ucsv(seeds: int) -> None:
    """Particle Gibbs on UC-SV at bench_pg.py's configuration, per method."""
    y = jnp.asarray(ucsv_series(T))
    for method in ("bs", "as"):
        cfg = smc.PGConfig(n_particles=PG_N, sweeps=PG_SWEEPS, chain=PG_CHAIN, method=method)
        rows = []
        for s in range(seeds):
            t0 = time.perf_counter()
            res = smc.particle_gibbs(jax.random.key(s), smc.ucsv_model, _ucsv_prior(), y, cfg)
            th = np.asarray(res.theta, np.float64)
            rows.append({"chain_mean": th[PG_BURN:].mean(0), "acc": float(res.acc_ratio)})
            print(json.dumps({"run": "pg_ucsv", "method": method, "seed": s,
                              "seconds": round(time.perf_counter() - t0, 2),
                              "chain_mean": rows[-1]["chain_mean"].round(6).tolist(),
                              "acc": round(rows[-1]["acc"], 4)}), flush=True)
        print(json.dumps({"run": "pg_ucsv", "method": method, "n": PG_N, "T": T,
                          "sweeps": PG_SWEEPS, "chain": PG_CHAIN, "burn": PG_BURN,
                          "seeds": seeds, **_report("chain_mean", rows),
                          **_report("acc", rows)}), flush=True)


def ffbs_ucsv(seeds: int) -> None:
    """FFBS marginals on UC-SV at θ = JAX_MEAN, N = FFBS_N."""
    from sequential_monte_carlo_tpu.ops.smoothing import smoothed_marginals, smoothed_mean

    model = smc.ucsv_model(jnp.asarray(JAX_MEAN, jnp.float32))
    y = jnp.asarray(ucsv_series(T))
    rows = []
    for s in range(seeds):
        t0 = time.perf_counter()
        out = smoothed_marginals(jax.random.key(s), model, FFBS_N, y)
        rows.append({"windows": window_means(np.asarray(smoothed_mean(out))),
                     "log_z": float(out.log_z)})
        print(json.dumps({"run": "ffbs_ucsv", "seed": s,
                          "seconds": round(time.perf_counter() - t0, 2),
                          "windows": rows[-1]["windows"].round(6).tolist(),
                          "log_z": round(rows[-1]["log_z"], 6)}), flush=True)
    lz = np.asarray([r["log_z"] for r in rows])
    print(json.dumps({"run": "ffbs_ucsv", "n": FFBS_N, "T": T, "seeds": seeds,
                      **_report("windows", rows),
                      "log_z_mean": round(lz.mean(), 6),
                      "log_z_var": round(lz.var(ddof=1), 6)}), flush=True)


def pg_lg(seeds: int) -> None:
    """Particle Gibbs on LG at the JAX test's configuration: the seeds'
    chain means against the prior-IS oracle."""
    y = jnp.asarray(lg_series(PG_LG_T))
    theta = _lg_prior().sample(jax.random.key(77), (100_000,))
    logz = jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(jax.vmap(smc.lg_model)(theta))
    oracle = np.asarray(jax.nn.softmax(logz) @ theta, np.float64)
    cfg = smc.PGConfig(n_particles=PG_LG_N, sweeps=PG_LG_SWEEPS, chain=PG_CHAIN)
    run = jax.jit(lambda k: smc.particle_gibbs(k, smc.lg_model, _lg_prior(), y, cfg).theta)
    rows = []
    for s in range(seeds):
        th = np.asarray(run(jax.random.key(s)), np.float64)
        rows.append({"chain_mean": th[PG_LG_BURN:].mean(0)})
        off = np.abs(rows[-1]["chain_mean"] - oracle)
        print(json.dumps({"run": "pg_lg", "seed": s,
                          "chain_mean": rows[-1]["chain_mean"].round(6).tolist(),
                          "within_0.3": bool(np.all(off < 0.3))}), flush=True)
    print(json.dumps({"run": "pg_lg", "n": PG_LG_N, "T": PG_LG_T, "sweeps": PG_LG_SWEEPS,
                      "seeds": seeds, "oracle": oracle.round(6).tolist(),
                      **_report("chain_mean", rows)}), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--run", default="dt",
                   choices=("dt", "apf_ucsv", "apf_lg", "ucsv_bank", "pg_ucsv", "ffbs_ucsv",
                            "pg_lg", "inflation_uc", "inflation_ucsv", "ucsv_animation"))
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--n", type=int, default=None)
    args = p.parse_args()
    if args.run == "ucsv_animation":
        ucsv_animation(args.seeds, args.n or 4096)
        return 0
    args.n = args.n or 1024
    if args.run == "ucsv_bank":
        ucsv_bank(args.seeds, args.m, args.n)
        return 0
    if args.run in ("pg_ucsv", "ffbs_ucsv", "pg_lg"):
        {"pg_ucsv": pg_ucsv, "ffbs_ucsv": ffbs_ucsv, "pg_lg": pg_lg}[args.run](args.seeds)
        return 0
    run = _runner(args.run, args.m, args.n)
    means = []
    for s in range(args.seeds):
        t0 = time.perf_counter()
        state, summary = run(jax.random.key(s))
        means.append(np.asarray(smc.expected_parameters(state), np.float64))
        print(json.dumps({"run": args.run, "seed": s,
                          "seconds": round(time.perf_counter() - t0, 2), **summary,
                          "posterior_mean": means[-1].round(6).tolist()}), flush=True)
    means = np.asarray(means)
    print(json.dumps({"run": args.run, "m": args.m, "n": args.n, "seeds": args.seeds,
                      "mean": means.mean(0).round(6).tolist(),
                      "sd": means.std(0, ddof=1).round(6).tolist()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
