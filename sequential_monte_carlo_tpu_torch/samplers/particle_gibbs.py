"""Particle Gibbs (L3) — counterpart of
``sequential_monte_carlo_tpu/samplers/particle_gibbs.py``: joint θ + x_{1:T}
inference by Gibbs sweeps of conditional SMC and complete-data
Metropolis–Hastings (Andrieu, Doucet & Holenstein 2010, §2.4–2.5):

    x_{1:T} ~ CSMC(x_prev; θ)                 (ops/csmc.py, any N ≥ 2)
    θ       ~ MH targeting p(θ | x_{1:T}, y)  (the complete-data density,
                                               O(T) a step, no filter)

with the random-walk scale λ·rw_sigma tuned by diminishing adaptation
(Andrieu & Thoms 2008 §4.3): log λ += s^{-0.6} (acc_s − target_accept).

Where the JAX package compiles the chain into one ``lax.scan`` over sweeps,
the port on the card replays one captured CUDA graph a sweep
(``ops/graphs.py::pg_chain``: the MH steps, the adaptation, the CSMC sweep
and the stores, at a sweep counter the graph advances), and elsewhere
loops over sweeps on the host; nothing in a sweep reads the device: the
acceptance, λ and θ stay tensors on the data's device. The
chain runs on a bank of CSMC rows (``ops/csmc.py``) of one row;
``_particle_gibbs_bank`` runs independent chains as the rows of one bank,
at the cost of one chain in launches. Unlike the JAX package, a scalar θ
runs as shape (1,) (the prior and ``model_fn`` still see the prior's own
shape), ``sweeps < 1`` raises, and the 1024 prior draws behind the default
``rw_sigma`` come from the caller's generator.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..models.base import broadcast_model
from ..ops import batched_filter, graphs
from ..ops.csmc import _csmc_bank, _csmc_eager
from ..ops.particle_filter import PFConfig
from ..ops.smoothing import _forward_bank, _sample_paths

__all__ = ["PGConfig", "PGResult", "complete_data_log_prob", "particle_gibbs"]

_MULTINOMIAL = PFConfig("multinomial")  # the initial paths' filter


class PGConfig(NamedTuple):
    """Static particle-Gibbs configuration ≡ the JAX ``PGConfig``."""

    n_particles: int = 256  # N: CSMC cloud size
    sweeps: int = 500  # Gibbs sweeps (= retained θ draws)
    chain: int = 1  # complete-data MH steps per sweep
    method: str = "bs"  # CSMC path draw: "bs" backward sampling | "as" PGAS
    rw_scale: float = 0.25  # initial θ-proposal std, × prior marginal std
    collect_paths: bool = False  # also return every sweep's trajectory
    target_accept: float = 0.234  # diminishing adaptation's target
    adapt: bool = True


class PGResult(NamedTuple):
    theta: torch.Tensor  # (sweeps, dθ) — the θ chain
    acc_ratio: torch.Tensor  # scalar: mean complete-data MH acceptance
    final_path: torch.Tensor  # (T, dx) — last retained trajectory
    paths: Optional[torch.Tensor] = None  # (sweeps, T, dx) if collect_paths


def complete_data_log_prob(model, x, y):
    """log p(x_{1:T}, y_{1:T} | θ) of one trajectory ``x`` (T, dx) under one
    θ's model: log μ(x_1) + Σ log f(x_t | x_{t−1}) + Σ log g(y_t | x_t); or
    of a bank's trajectories x (T, M, dx) under its M rows, (M,)."""
    y = y.reshape(y.shape + (1,) * (x.dim() - 2))
    lp = model.initial_distribution().log_prob(x[0])
    lp = lp + torch.sum(model.transition_distribution(x[:-1]).log_prob(x[1:]), dim=0)
    return lp + torch.sum(model.observation_distribution(x).log_prob(y), dim=0)


def particle_gibbs(generator, model_fn, prior, y, config: PGConfig = PGConfig(),
                   theta0=None, rw_sigma=None) -> PGResult:
    """Run a particle-Gibbs chain.

    Args:
      model_fn: θ ↦ one θ's model (the samplers' constructor contract).
      prior: distribution over θ with sample / log_prob / in_support.
      y: (T,) observations, on the device the chain runs on.
      theta0: start, default a prior draw.
      rw_sigma: base MH proposal stds, default ``config.rw_scale`` × the
        std of 1024 prior draws; the effective scale is λ·rw_sigma, λ
        adapted by diminishing adaptation.

    Returns a :class:`PGResult`; discard a burn-in of ``result.theta``
    before summarizing (the chain starts at ``theta0``)."""
    if config.chain < 1:
        raise ValueError(
            f"config.chain must be >= 1 (got {config.chain}); for pure CSMC state "
            "sampling at fixed theta, iterate ops.csmc_sweep directly")
    if config.sweeps < 1:
        raise ValueError(f"config.sweeps must be >= 1 (got {config.sweeps})")
    if config.method not in ("bs", "as"):
        raise ValueError(f"unknown method {config.method!r}; one of ['bs', 'as']")
    if theta0 is None:
        theta0 = prior.sample(generator)
    theta0 = torch.as_tensor(theta0, dtype=torch.float32, device=y.device)

    @functools.wraps(model_fn)  # the captured route's key: model_fn itself
    def bank_fn(th):
        return broadcast_model(model_fn(th[0]))

    res = _particle_gibbs_bank(generator, bank_fn, prior, y, config, theta0[None], rw_sigma)
    return PGResult(theta=res.theta[:, 0], acc_ratio=res.acc_ratio[0],
                    final_path=res.final_path[:, 0],
                    paths=None if res.paths is None else res.paths[:, :, 0])


def _log_target(prior, bank, th, path, y, event):
    """log p(θ) + log p(x, y | θ) per chain (θ (K, d), the prior seeing
    shape ``event``), −inf where not finite."""
    k = th.shape[0]
    lp = (prior.log_prob(th.reshape(event)).reshape(k)
          + complete_data_log_prob(bank, path, y).reshape(k))
    return torch.where(torch.isfinite(lp), lp, -torch.inf)


def _sweep(generator, y, rw_sigma, theta, log_lam, path, rate, *, bank_fn, prior,
           config: PGConfig, event, csmc=_csmc_bank):
    """One Gibbs sweep of K chains from θ (K, d), log λ (K,) and their
    paths (T, K, dx): ``config.chain`` complete-data MH steps at the paths
    (the bank built at each proposal by ``bank_fn``), the diminishing
    adaptation of log λ at ``rate`` (s + 1)^−0.6, then x | θ, y by one
    CSMC sweep (``csmc``, :func:`~..ops.csmc._csmc_bank`'s signature) of
    the bank at the new θ. Returns (θ, log λ, the acceptance (K,), the new
    paths). The eager loop's body and, with the eager CSMC sweep, the one
    the particle-Gibbs route captures."""
    k, f32 = theta.shape[0], dict(dtype=torch.float32, device=theta.device)
    lam = torch.exp(log_lam)[:, None]
    lp, n_acc = _log_target(prior, bank_fn(theta.reshape(event)), theta, path, y, event), 0.0
    for _ in range(config.chain):
        prop = theta + lam * rw_sigma * torch.randn(theta.shape, generator=generator, **f32)
        lp_prop = torch.where(prior.in_support(prop.reshape(event)).reshape(k),
                              _log_target(prior, bank_fn(prop.reshape(event)), prop, path, y,
                                          event), -torch.inf)
        u = torch.rand(k, generator=generator, **f32)
        accept = (lp_prop > -torch.inf) & (torch.log(u) < lp_prop - lp)
        theta = torch.where(accept[:, None], prop, theta)
        lp = torch.where(accept, lp_prop, lp)
        n_acc = n_acc + accept.to(torch.float32)
    acc = n_acc / config.chain
    if config.adapt:
        log_lam = log_lam + rate * (acc - config.target_accept)
    path, _ = csmc(generator, bank_fn(theta.reshape(event)), config.n_particles, y, path,
                   config.method == "as", config.method)
    return theta, log_lam, acc, path


def _particle_gibbs_bank(generator, bank_fn, prior, y, config: PGConfig, theta0,
                         rw_sigma=None) -> PGResult:
    """K independent particle-Gibbs chains as the rows of one bank (one
    CSMC launch a step for all of them).

    ``bank_fn`` maps a θ-cloud (K, *event) to its K-row bank, ``theta0``
    (K, *event) is the chains' start, ``event`` the prior's own θ shape;
    ``config`` as :func:`particle_gibbs` checks it.
    The result has a chain axis after the sweep axis: θ (sweeps, K, dθ),
    acceptances (K,), final paths (T, K, dx), paths (sweeps, T, K, dx).

    On the card, where the bank's route is captured, each sweep replays one
    CUDA graph (``ops/graphs.py::pg_chain``); else, and inside
    ``disable_graphs()``, the sweeps loop on the host. The set-up (θ0, the
    default rw_sigma's prior draws, the initial paths) runs before either."""
    n, device = config.n_particles, y.device
    f32 = dict(dtype=torch.float32, device=device)
    theta0 = torch.as_tensor(theta0, **f32)
    k, event = theta0.shape[0], tuple(theta0.shape)
    theta = theta0.reshape(k, -1)

    if rw_sigma is None:
        draws = prior.sample(generator, (1024,)).reshape(1024, -1)
        rw_sigma = config.rw_scale * torch.std(draws, dim=0, correction=0)
    rw_sigma = torch.broadcast_to(torch.as_tensor(rw_sigma, **f32).reshape(-1), theta.shape[1:])

    # the initial paths: one multinomial filter at θ0 and one backward draw
    bank = bank_fn(theta.reshape(event))
    xs, lw, _ = _forward_bank(generator, bank, n, k, y, _MULTINOMIAL)
    path = _sample_paths(generator, xs.transpose(1, 2), lw.transpose(1, 2), bank, 1)[:, 0]
    log_lam = torch.zeros(k, **f32)
    if (batched_filter.captures(_MULTINOMIAL, None, device)
            and not getattr(bank, "params_read_host", False)):
        static = (config._replace(sweeps=0), event)
        thetas, accs, path, paths = graphs.pg_chain(
            generator, config.sweeps, static, bank_fn, prior, bank, theta, path, rw_sigma, y,
            config.collect_paths,
            functools.partial(_sweep, config=config, event=event, csmc=_csmc_eager))
        return PGResult(theta=thetas, acc_ratio=torch.mean(accs, dim=0), final_path=path,
                        paths=paths)
    thetas, accs, paths = [], [], []
    for s in range(config.sweeps):
        theta, log_lam, acc, path = _sweep(generator, y, rw_sigma, theta, log_lam, path,
                                           (s + 1.0) ** -0.6, bank_fn=bank_fn, prior=prior,
                                           config=config, event=event)
        thetas.append(theta)
        accs.append(acc)
        if config.collect_paths:
            paths.append(path)
    return PGResult(theta=torch.stack(thetas), acc_ratio=torch.mean(torch.stack(accs), dim=0),
                    final_path=path,
                    paths=torch.stack(paths) if config.collect_paths else None)
