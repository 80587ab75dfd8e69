"""What the drivers share: the program's prior and inner filter built from
the configuration's data, and the sample of calls a check reads."""
from __future__ import annotations

import numpy as np

from port_bench.harness import catalog, seeds

# the precision below each stated one (float32 → bfloat16: no matmul here
# runs on the tensor cores, so TF32 does not apply)
BELOW = {"float32": "bfloat16"}


def program_prior(torch, smc, rows, device):
    """The configuration's prior built from the program's own distributions:
    each row's kind names the port's distribution (its ``PROGRAM``)."""
    dists = []
    for name, *params in rows:
        program = catalog.load_module("reference/prior_kinds", name).PROGRAM
        if program is None:
            raise ValueError(f"prior kind {name!r} has no distribution in the program")
        dists.append(getattr(smc, program)(*(torch.tensor(float(p), device=device)
                                             for p in params)))
    return smc.product_distribution(dists)


def pf_config(smc, inner: dict):
    """The program's inner filter from the workload's ``inner`` object,
    every key a field of ``PFConfig`` (resampling, ess_threshold, algorithm)."""
    return smc.PFConfig(**inner)


def carries(inner: dict) -> bool:
    """Whether the inner filter carries log-weights between steps (it
    resamples only under an ESS threshold)."""
    return float(inner.get("ess_threshold", 1.0)) < 1.0


def control_dtype(torch, config: dict):
    return getattr(torch, BELOW[config.get("precision", "float32")])


def sample(seed: int, n: int, k: int) -> list:
    """k of the n call positions (all where n ≤ k), drawn from the seed."""
    rng = np.random.default_rng(seeds.stream_seed(seed, "sample"))
    return sorted(rng.choice(n, size=min(n, k), replace=False).tolist())
