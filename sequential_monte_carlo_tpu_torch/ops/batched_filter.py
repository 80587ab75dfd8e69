"""Batched (θ-cloud-level) particle filtering — L2.5, the slice's subset of
``sequential_monte_carlo_tpu/ops/batched_filter.py``.

All M per-θ filters step as one (M, N) program. Every inner step is two
hand-written kernels: the systematic resample + ancestor gather
(``kernels/resample_walk.py``) and the model's fused propagate + reweight +
normalize (``kernels/propagate.py``). This slice covers the bootstrap filter
with systematic resampling at every step (``PFConfig("systematic", 1.0)``);
other configurations raise ``NotImplementedError`` naming the ROADMAP item
that adds them.

Layout: particles are (M, N, dx) at the public functions, as in the JAX
package, but their storage is planar — the (M, dx, N) cloud that both
kernels read and write, seen through a transposed view (:func:`as_cloud`,
:func:`from_cloud`) — so no step copies the cloud between layouts.

Randomness: :func:`batched_pf_step` draws the systematic offsets u0 (M, 1)
and, on a GPU, one Philox seed (the kernel draws its normals), on the CPU
the normals themselves, from an explicit ``torch.Generator``; the
deterministic rest of the step is :func:`_pf_step_from_draws`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.resample_walk import resample_gather
from .particle_filter import PFConfig
from .weights import log_normalize

__all__ = [
    "BatchedPFOut",
    "as_cloud",
    "from_cloud",
    "batched_pf_init",
    "batched_pf_step",
    "batched_log_likelihood_masked",
]


class BatchedPFOut(NamedTuple):
    particles: torch.Tensor  # (M, N, dx), planar storage
    log_weights: torch.Tensor  # (M, N) normalized per row
    log_mean: torch.Tensor  # (M,) incremental evidence per θ
    ess: torch.Tensor  # (M,)


def as_cloud(particles: torch.Tensor) -> torch.Tensor:
    """(M, N, dx) particles → the contiguous (M, dx, N) cloud; no copy when
    the storage is already planar."""
    return particles.transpose(1, 2).contiguous()


def from_cloud(cloud: torch.Tensor) -> torch.Tensor:
    """(M, dx, N) cloud → (M, N, dx) particles, as a view."""
    return cloud.transpose(1, 2)


def _check_config(config: PFConfig) -> None:
    if config.algorithm != "bootstrap":
        raise NotImplementedError(
            f"algorithm={config.algorithm!r}: the APF comes with ROADMAP "
            "Queue 1 item 7"
        )
    if config.proposal is not None:
        raise NotImplementedError(
            "guided proposals come with ROADMAP Queue 1 item 7"
        )
    if config.resampling != "systematic":
        raise NotImplementedError(
            f"resampling={config.resampling!r}: the batched filter resamples "
            "systematically; other schemes come with ROADMAP Queue 1 item 7"
        )
    if config.ess_threshold < 1.0:
        raise NotImplementedError(
            "adaptive resampling (ess_threshold < 1) comes with ROADMAP "
            "Queue 1 item 7"
        )


def batched_pf_init(generator, models, n: int, m: int, y0,
                    config: PFConfig = PFConfig()) -> BatchedPFOut:
    """Bootstrap init of all M filters at y0: N draws from each θ's initial
    distribution, weighted by the observation density."""
    _check_config(config)
    x = models.initial_distribution().sample(generator, (n,))  # (N, M, dx)
    if tuple(x.shape[:2]) != (n, m):
        raise ValueError(f"models must carry {m} θ, drew shape {tuple(x.shape)}")
    particles = from_cloud(x.permute(1, 2, 0).contiguous())
    logw = models.observation_distribution(particles).log_prob(y0)
    log_mean, log_norm, ess = log_normalize(logw)
    return BatchedPFOut(particles, log_norm, log_mean, ess)


def _draws(generator, models, m: int, n: int, device):
    """The step's randomness: u0 (M, 1), then a (1,) int64 Philox seed on
    a GPU or (n_normals, M, N) normals on the CPU."""
    u0 = torch.rand((m, 1), generator=generator, device=device)
    if device.type == "cpu":
        rest = torch.randn((models.update.n_normals, m, n), generator=generator)
    else:
        rest = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=device, dtype=torch.int64)
    return u0, rest


def _pf_step_from_draws(u0, seed_or_normals, models, particles, log_w, y):
    """Deterministic core of :func:`batched_pf_step`: kernel 1 (resample +
    gather by the systematic offsets ``u0``) then kernel 2 (propagate +
    reweight + normalize, with its Philox seed — an int64 tensor — or its
    injected normals — a float tensor)."""
    n = particles.shape[1]
    xp = resample_gather(u0, torch.exp(log_w), as_cloud(particles))
    if seed_or_normals.dtype == torch.int64:
        draws = {"seed": seed_or_normals}
    else:
        draws = {"normals": seed_or_normals}
    cloud, log_norm, lse, ess = models.fused_propagate_reweight(y, xp, **draws)
    # kernel 2's lse is of the unnormalized weights; the evidence increment
    # is their log-mean (the weights after resampling are all 1/N)
    return BatchedPFOut(from_cloud(cloud), log_norm, lse[:, 0] - math.log(n),
                        ess[:, 0])


def batched_pf_step(generator, models, particles, log_w, y,
                    config: PFConfig = PFConfig()) -> BatchedPFOut:
    """One filter step for all M clouds: resample every row, propagate,
    reweight by y and normalize."""
    _check_config(config)
    m, n, _ = particles.shape
    u0, rest = _draws(generator, models, m, n, particles.device)
    return _pf_step_from_draws(u0, rest, models, particles, log_w, y)


def batched_log_likelihood_masked(generator, models, n: int, m: int, y, mask,
                                  config: PFConfig = PFConfig()):
    """Log-likelihood of the observations y[t] with mask[t] > 0 for all M θ —
    the rejuvenation inner loop. Initializes at y[0] and steps only at the
    live times t ≥ 1 (a Python loop over them, where the JAX package runs a
    masked scan over all T). ``mask`` is read on the host.

    Returns (particles (M, N, dx), log_w (M, N), log Z (M,))."""
    init = batched_pf_init(generator, models, n, m, y[0], config)
    particles, log_w, logz = init.particles, init.log_weights, init.log_mean
    live = torch.nonzero(torch.as_tensor(mask).cpu()[1:] > 0).flatten() + 1
    for t in live.tolist():
        out = batched_pf_step(generator, models, particles, log_w, y[t], config)
        particles, log_w = out.particles, out.log_weights
        logz = logz + out.log_mean
    return particles, log_w, logz
