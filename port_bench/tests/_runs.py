"""Small sizes at which the CPU tests drive whole runs of the cells (the
program's plain versions of its kernels run there)."""
import time

from port_bench.harness import cli

# SMC² over the whole series, so that the posterior is narrow enough for a
# move that targets the prior to show
TINY = {"smc2_ucsv_512x8192": {"m": 64, "n": 256, "check_calls": 12, "reference_runs": 4},
        "filters_lg_64x65536": {"m": 8, "n": 4096, "t": 20, "check_calls": 6}}
SECONDS = {"smc2_ucsv_512x8192": 20.0, "filters_lg_64x65536": 4.0}
# the limits of these sizes, from CPU readings at them: sound SMC² runs
# read an evidence gap up to 1.2 nats, a distinct-θ gap up to 0.36 and a
# posterior mean gap up to 1.03 sds (one call a window); the sampler's
# faults 2.5–2.9 (distinct, a move left out) and 2.1–5.2 (mean, a move
# that targets the prior)
LIMITS = {"smc2_ucsv_512x8192": {"evidence_gap": 1.5, "theta_distinct_gap": 0.5,
                                  "posterior_mean_gap": 1.5, "lse_err": 1e-3},
          "filters_lg_64x65536": {"logz_gap": 0.1, "lse_err": 1e-3}}


def run(name, seed=2**31 + 11, seconds=None, program="program", overrides=None, **kw):
    return cli.run_cell(name, seed, seconds or SECONDS[name], False, "cpu", time.perf_counter(),
                        overrides={**TINY[name], **(overrides or {})}, program=program,
                        limits=LIMITS[name], **kw)
