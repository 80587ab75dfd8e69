"""Batched (θ-cloud-level) particle filtering — L2.5, the port's subset of
``sequential_monte_carlo_tpu/ops/batched_filter.py``.

All M per-θ filters step as one (M, N) program. Every inner step is two
hand-written kernels: a resample + ancestor gather — systematic by offsets
u0 (``kernels/resample_walk.py``) or stratified on an explicit sorted grid
(``kernels/resample_sorted.py``) — and the model's fused propagate +
reweight (``kernels/propagate.py``, or ``kernels/ucsv.py`` for the UC-SV
auxiliary filter). This covers ``PFConfig("systematic" | "stratified",
ess_threshold)`` with the bootstrap filter or, at ``ess_threshold`` 1, the
auxiliary particle filter (``algorithm="apf"``); other configurations raise
``NotImplementedError`` naming the ROADMAP item that adds them.

Auxiliary particle filter (Pitt & Shephard 1999), ≡ the JAX package's
``_batched_apf_step``: the first-stage weights look ahead through the
transition mean, λ = log w + log g(y | E[x′ | x]) (plain tensor glue over the
models' distributions); the resample kernel draws ancestors by λ and gathers
the cloud with log g as one extra plane, so the ancestors' lookahead comes
out of the same launch; the model's step without the normalize gives the
raw log-weights of the propagated cloud, corrected by the ancestors'
lookahead and normalized here, with the evidence increment
log Σ exp(λ) + log mean exp(corr).

Adaptive resampling (``ess_threshold < 1``): a row fires when its ESS
1/Σw² falls below ``ess_threshold·N``. The step reads nothing on the host to
decide: it resamples and gathers every row, then keeps the gathered cloud and
the weights −log N on the rows that fired and the old cloud and log-weights
on the others (per-row selects on the device, the formulation the JAX
package's ``lax.cond`` is bitwise equal to). The carried log-weights ride
into the propagate kernel (``carry_logw``), whose normalize then gives the
evidence increment log Σ w·g directly.

Layout: particles are (M, N, dx) at the public functions, as in the JAX
package, but their storage is planar — the (M, dx, N) cloud that the
kernels read and write, seen through a transposed view (:func:`as_cloud`,
:func:`from_cloud`) — so no step copies the cloud between layouts.

Randomness: :func:`batched_pf_step` draws the resampling grid — offsets u0
(M, 1) or a stratified grid u (M, N) — and, on a GPU, one Philox seed (the
kernel draws its normals), on the CPU the normals themselves, from an
explicit ``torch.Generator``; the deterministic rest of the step is
:func:`_pf_step_from_draws`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.resample_sorted import resample_gather_sorted, stratified_uniforms
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
    "batched_log_likelihood",
]

# inner resampling scheme -> its resample + gather kernel
_RESAMPLE = {"systematic": resample_gather, "stratified": resample_gather_sorted}


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


def _check_config(config: PFConfig, active_n=None) -> None:
    if config.algorithm not in ("bootstrap", "apf"):
        raise ValueError(
            f"unknown algorithm {config.algorithm!r}; one of ['bootstrap', 'apf']"
        )
    if config.algorithm == "apf":  # the JAX package's errors
        if active_n is not None:
            raise ValueError(
                "algorithm='apf' is not defined for the elastic padded-N mode "
                "(use elastic_pad='grow' samplers or bootstrap)"
            )
        if config.proposal is not None:
            raise ValueError(
                "algorithm='apf' propagates from the transition (the lookahead "
                "replaces the proposal role); proposal= composes with the "
                "bootstrap algorithm only"
            )
        if config.ess_threshold < 1.0:
            raise ValueError(
                "algorithm='apf' resamples by construction every step (the "
                "first-stage lookahead IS the resample); ess_threshold < 1 "
                "composes with the bootstrap algorithm only"
            )
    if active_n is not None:
        raise NotImplementedError(
            "the elastic live-particle count active_n comes with ROADMAP "
            "Queue 1 item 7"
        )
    if config.proposal is not None:
        raise NotImplementedError(
            "guided proposals come with ROADMAP Queue 1 item 7"
        )
    if config.resampling not in _RESAMPLE:
        raise NotImplementedError(
            f"resampling={config.resampling!r}: the batched filter resamples "
            f"by one of {sorted(_RESAMPLE)}; the other schemes come with "
            "ROADMAP Queue 1 item 7"
        )


def batched_pf_init(generator, models, n: int, m: int, y0,
                    config: PFConfig = PFConfig(), active_n=None) -> BatchedPFOut:
    """Init of all M filters at y0 (the bootstrap's, for the auxiliary
    filter too): N draws from each θ's initial distribution, weighted by the
    observation density."""
    _check_config(config, active_n)
    x = models.initial_distribution().sample(generator, (n,))  # (N, M, dx)
    if tuple(x.shape[:2]) != (n, m):
        raise ValueError(f"models must carry {m} θ, drew shape {tuple(x.shape)}")
    logw = models.observation_distribution(x).log_prob(y0).T.contiguous()
    log_mean, log_norm, ess = log_normalize(logw)
    return BatchedPFOut(from_cloud(x.permute(1, 2, 0).contiguous()), log_norm,
                        log_mean, ess)


def _draws(generator, models, m: int, n: int, device,
           config: PFConfig = PFConfig()):
    """The step's randomness: the resampling grid — u0 (M, 1) for
    systematic, a stratified u (M, N) — then a (1,) int64 Philox seed on a
    GPU or (n_normals, M, N) normals on the CPU."""
    if config.resampling == "stratified":
        u = stratified_uniforms(generator, m, n, device)
    else:
        u = torch.rand((m, 1), generator=generator, device=device)
    if device.type == "cpu":
        rest = torch.randn((models.update.n_normals, m, n), generator=generator)
    else:
        rest = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=device, dtype=torch.int64)
    return u, rest


def _propagate_draws(seed_or_normals) -> dict:
    """The propagate kernel's draws: its Philox seed (an int64 tensor) or
    its injected normals (a float tensor)."""
    if seed_or_normals.dtype == torch.int64:
        return {"seed": seed_or_normals}
    return {"normals": seed_or_normals}


def _pf_step_from_draws(u, seed_or_normals, models, particles, log_w, y,
                        config: PFConfig = PFConfig(), params=None):
    """Deterministic core of :func:`batched_pf_step`: the resample kernel
    (systematic offsets u0 or sorted grid u, per ``config.resampling``),
    the adaptive per-row selects when ``config.ess_threshold < 1``, then the
    propagate kernel with its Philox seed — an int64 tensor — or its
    injected normals — a float tensor. ``params`` are the model's
    step-invariant kernel parameters (``models.fused_params()``)."""
    n = particles.shape[1]
    cloud = as_cloud(particles)
    w = torch.exp(log_w)
    xp = _RESAMPLE[config.resampling](u, w, cloud)
    carry = None
    if config.ess_threshold < 1.0:
        fire = 1.0 / torch.sum(w * w, dim=-1) < config.ess_threshold * n
        xp = torch.where(fire[:, None, None], xp, cloud)
        carry = torch.where(fire[:, None], -math.log(n), log_w)
    new, log_norm, lse, ess = models.fused_propagate_reweight(
        y, xp, carry_logw=carry, params=params, **_propagate_draws(seed_or_normals))
    # the evidence increment: with a carry (normalized weights), lse of
    # carry + logw; else the log-mean of the unnormalized weights (the
    # weights after resampling are all 1/N)
    log_mean = lse[:, 0] if carry is not None else lse[:, 0] - math.log(n)
    return BatchedPFOut(from_cloud(new), log_norm, log_mean, ess[:, 0])


def apf_lookahead(models, particles, y) -> torch.Tensor:
    """The auxiliary filter's lookahead log g(y | E[x′ | x]), (M, N), of the
    (M, N, dx) particles."""
    # the models' distributions take states with the θ axis just before the
    # state axis: the (N, M, dx) view of the particles
    mu = models.transition_distribution(particles.transpose(0, 1)).mean()
    return models.observation_distribution(mu).log_prob(y).T


def _apf_step_from_draws(u, seed_or_normals, models, particles, log_w, y,
                         config: PFConfig = PFConfig(), params=None):
    """Deterministic core of the auxiliary particle filter's step (the
    draws as in :func:`_pf_step_from_draws`): the lookahead, one resample
    launch on the (M, dx + 1, N) cloud with the lookahead plane, the model's
    step without the normalize on the split-off planes (a strided view, not
    copied), then the correction and the normalize."""
    n, dx = particles.shape[1], particles.shape[2]
    log_n = math.log(n)
    log_g_mu = apf_lookahead(models, particles, y)
    lam_mean, lam_norm, _ = log_normalize(log_w + log_g_mu)
    aug = torch.cat([as_cloud(particles), log_g_mu[:, None, :]], dim=1)
    gathered = _RESAMPLE[config.resampling](u, torch.exp(lam_norm), aug)
    new, incr = models.fused_propagate_reweight(y, gathered[:, :dx], params=params,
                                                normalize=False,
                                                **_propagate_draws(seed_or_normals))
    corr_mean, log_norm, ess = log_normalize(incr - gathered[:, dx])
    return BatchedPFOut(from_cloud(new), log_norm, lam_mean + log_n + corr_mean, ess)


def batched_pf_step(generator, models, particles, log_w, y,
                    config: PFConfig = PFConfig(), params=None,
                    active_n=None) -> BatchedPFOut:
    """One filter step for all M clouds: resample (every row, or the rows
    whose ESS fell below ``config.ess_threshold``·N), propagate, reweight by
    y and normalize — or, with ``config.algorithm == "apf"``, the auxiliary
    particle filter's step. ``params``: ``models.fused_params()``, computed
    once by callers that step the same models many times."""
    _check_config(config, active_n)
    m, n, _ = particles.shape
    u, rest = _draws(generator, models, m, n, particles.device, config)
    step = _apf_step_from_draws if config.algorithm == "apf" else _pf_step_from_draws
    return step(u, rest, models, particles, log_w, y, config, params)


def batched_log_likelihood_masked(generator, models, n: int, m: int, y, mask,
                                  config: PFConfig = PFConfig(), active_n=None):
    """Log-likelihood of the observations y[t] with mask[t] > 0 for all M θ —
    the rejuvenation inner loop. Initializes at y[0] and steps only at the
    live times t ≥ 1 (a Python loop over them, where the JAX package runs a
    masked scan over all T). ``mask`` is read on the host; the model's
    kernel parameters are packed once, outside the loop.

    Returns (particles (M, N, dx), log_w (M, N), log Z (M,))."""
    init = batched_pf_init(generator, models, n, m, y[0], config, active_n)
    particles, log_w, logz = init.particles, init.log_weights, init.log_mean
    params = models.fused_params()
    live = torch.nonzero(torch.as_tensor(mask).cpu()[1:] > 0).flatten() + 1
    for t in live.tolist():
        out = batched_pf_step(generator, models, particles, log_w, y[t], config,
                              params)
        particles, log_w = out.particles, out.log_weights
        logz = logz + out.log_mean
    return particles, log_w, logz


def batched_log_likelihood(generator, models, n: int, m: int, y,
                           config: PFConfig = PFConfig(), active_n=None):
    """Full-sequence log-likelihood for all M θ (the density-tempered init).
    Returns (particles (M, N, dx), log_w (M, N), log Z (M,))."""
    return batched_log_likelihood_masked(generator, models, n, m, y,
                                         torch.ones(y.shape[0]), config, active_n)
