"""Smoothing (L2) — counterpart of
``sequential_monte_carlo_tpu/ops/smoothing.py``: the Rauch–Tung–Striebel
Kalman smoother (the linear-Gaussian oracle) and the forward-filter
backward-smoother on particles, for any model with a pointwise
``transition_distribution``.

- :func:`kalman_smooth` — the RTS backward pass over the port's
  ``kalman_step`` (filtered and one-step-ahead predicted moments).
- :func:`forward_clouds` — the bootstrap filter storing every step's cloud:
  the batched filter at one row (``ops/particle_filter.py``), so on a GPU K1
  and the model's fused propagate at M = 1; :func:`posterior_smoothed_paths`
  runs its n_theta filters as one (n_theta, N) bank of the same layer. On
  the card both replay CUDA graphs that store every step
  (``ops/graphs.py``); the backward passes stay eager.
- :func:`smoothed_marginals` — backward reweighting (Hürzeler & Künsch
  1998; Doucet, Godsill & Andrieu 2000)

      W_{t|T}^i ∝ w_t^i · Σ_j f(x_{t+1}^j | x_t^i) · W_{t+1|T}^j
                              / Σ_k w_t^k f(x_{t+1}^j | x_t^k)

  over the pairwise transition densities, each a broadcast of the (N, 1, dx)
  cloud at t against the (1, N, dx) cloud at t + 1: dense (N, N) log-sum-exp
  reductions up to N = 2048, above it (1024, N) row blocks with a streaming
  log-sum-exp for the denominator (its −inf column guard as in the JAX
  package), computing each block's densities twice.
- :func:`sample_smoothed_paths` — backward sampling (Godsill, Doucet & West
  2004), one categorical per path and step, batched over paths (and over θ
  for the posterior mixture).

The backward passes are plain tensor code, as in the JAX package, where
they are XLA outside any Pallas kernel. Categorical draws invert the CDF of
one uniform each, from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.base import broadcast_model
from . import batched_filter, graphs
from .batched_filter import as_cloud, batched_pf_init, batched_pf_step, kernel_params
from .kalman import kalman_init, kalman_step
from .particle_filter import PFConfig, _config
from .resampling import _inverse_cdf

__all__ = ["SmoothedCloud", "forward_clouds", "kalman_smooth", "posterior_smoothed_paths",
           "sample_smoothed_paths", "smoothed_marginals", "smoothed_mean"]

# smoothed_marginals' automatic backward route: dense up to this N, else
# row blocks of _BLOCK
_DENSE_MAX_N, _BLOCK = 2048, 1024


# ---------------------------------------------------------------------------
# exact RTS smoother (linear-Gaussian oracle)
# ---------------------------------------------------------------------------

def kalman_smooth(model, y):
    """RTS smoother of one linear-Gaussian model: (smoothed means (T, dx),
    covariances (T, dx, dx)). The forward pass is the Kalman filter,
    collecting the predicted moments; the backward pass

        G_t = P_t Aᵀ P̂_{t+1}⁻¹
        m_{t|T} = m_t + G_t (m_{t+1|T} − m̂_{t+1})
        P_{t|T} = P_t + G_t (P_{t+1|T} − P̂_{t+1}) G_tᵀ
    """
    state, filt, pred = kalman_init(model), [], []
    for t in range(y.shape[0]):
        out = kalman_step(model, state, y[t])
        state = out.state
        filt.append(out.state)
        pred.append(out.predicted)
    ms, ps = filt[-1]
    means, covs = [ms], [ps]
    for t in range(y.shape[0] - 2, -1, -1):
        mf, pf = filt[t]
        mp, pp = pred[t + 1]
        # G = Pf Aᵀ Pp⁻¹ (Pp symmetric: solve on the left and transpose)
        g = torch.linalg.solve(pp, model.A @ pf).mT
        ms = mf + (g @ (ms - mp)[..., None])[..., 0]
        ps = pf + g @ (ps - pp) @ g.mT
        means.append(ms)
        covs.append(ps)
    return torch.stack(means[::-1]), torch.stack(covs[::-1])


# ---------------------------------------------------------------------------
# forward filter storing every cloud
# ---------------------------------------------------------------------------

class SmoothedCloud(NamedTuple):
    particles: torch.Tensor  # (T, N, dx) — the forward filter's clouds
    log_weights: torch.Tensor  # (T, N) smoothed, normalized per step
    filter_log_weights: torch.Tensor  # (T, N) filtered, normalized per step
    log_z: torch.Tensor  # scalar marginal-likelihood estimate (forward pass)


def _forward_bank(generator, models, n: int, m: int, y, config: PFConfig):
    """The batched filter over all of y for a bank of m models, storing
    every step's cloud: (particles (T, m, N, dx), filtered log-weights
    (T, m, N), log Z (m,)). On the card, where the route is captured, the
    steps replay CUDA graphs that store each cloud into (T, m, dx, N) and
    each set of log-weights into (T, m, N) (``ops/graphs.py``)."""
    out = batched_pf_init(generator, models, n, m, y[0], config)
    params = kernel_params(models, config)
    if y.shape[0] > 1 and batched_filter.captures(config, None, out.log_weights.device):
        _, _, logz, (clouds, lws) = graphs.filter_stored(
            generator, models, out, params, y, config,
            lambda o: (as_cloud(o.particles), o.log_weights), ("forward_bank",))
        return clouds.transpose(-1, -2), lws, logz
    clouds, lws, logz = [as_cloud(out.particles)], [out.log_weights], out.log_mean
    for t in range(1, y.shape[0]):
        out = batched_pf_step(generator, models, out.particles, out.log_weights, y[t], config,
                              params)
        clouds.append(as_cloud(out.particles))
        lws.append(out.log_weights)
        logz = logz + out.log_mean
    return torch.stack(clouds).transpose(-1, -2), torch.stack(lws), logz


def forward_clouds(generator, model, n: int, y, config: PFConfig = PFConfig()):
    """The per-θ bootstrap (or guided) filter storing every cloud:
    (particles (T, N, dx), filtered log-weights (T, N), log Z). The init
    draws from ``config.proposal``'s q0 where the step draws from its q
    (the JAX package's init is the bootstrap's either way)."""
    xs, lw, logz = _forward_bank(generator, broadcast_model(model), n, 1, y, _config(config))
    return xs[:, 0], lw[:, 0], logz[0]


# ---------------------------------------------------------------------------
# backward reweighting (marginal smoother)
# ---------------------------------------------------------------------------

def _pairwise_transition_logpdf(model, x_t, x_next):
    """(N, dx), (N′, dx) → (N, N′): log f(x_next[j] | x_t[i]) at [i, j], the
    (N, 1, dx) states broadcast against the (1, N′, dx) ones."""
    return model.transition_distribution(x_t[:, None, :]).log_prob(x_next[None, :, :])


def _backward_reweight_dense(model, x_t, lw_t, x_next, lw_s_next):
    """One backward update over the dense (N, N) pairwise matrix."""
    log_d = _pairwise_transition_logpdf(model, x_t, x_next)
    log_denom = torch.logsumexp(lw_t[:, None] + log_d, dim=0)  # (N,) over j
    lw_s = lw_t + torch.logsumexp(log_d + (lw_s_next - log_denom)[None, :], dim=1)
    return lw_s - torch.logsumexp(lw_s, dim=0)


def _backward_reweight_blocked(model, x_t, lw_t, x_next, lw_s_next, nb: int):
    """The same update in (nb, N) row blocks — O(nb·N) memory, each block's
    pairwise densities computed twice. The denominator streams over the
    blocks as a running (max, rescaled sum); a column whose running max is
    still −inf (every contribution so far underflowed) keeps its sum at 0
    instead of exp(−inf − −inf) = NaN, so it ends at −inf as on the dense
    route."""
    n = x_t.shape[0]
    m_run = torch.full((n,), -torch.inf, dtype=lw_t.dtype, device=lw_t.device)
    s_run = torch.zeros((n,), dtype=lw_t.dtype, device=lw_t.device)
    for b in range(0, n, nb):
        part = lw_t[b:b + nb, None] + _pairwise_transition_logpdf(model, x_t[b:b + nb], x_next)
        m_new = torch.maximum(m_run, torch.amax(part, dim=0))
        safe = torch.isfinite(m_new)
        s_run = (torch.where(safe, s_run * torch.exp(m_run - m_new), 0.0)
                 + torch.sum(torch.where(safe[None, :], torch.exp(part - m_new[None, :]), 0.0),
                             dim=0))
        m_run = m_new
    c = lw_s_next - (m_run + torch.log(s_run))
    lw_s = torch.cat([
        lw_t[b:b + nb] + torch.logsumexp(
            _pairwise_transition_logpdf(model, x_t[b:b + nb], x_next) + c[None, :], dim=1)
        for b in range(0, n, nb)])
    return lw_s - torch.logsumexp(lw_s, dim=0)


def _block_size(n: int, block_size) -> int:
    if block_size is None:
        block_size = n if n <= _DENSE_MAX_N else _BLOCK
    if n % block_size:
        raise ValueError(f"block_size {block_size} must divide n {n}")
    return block_size


def backward_reweight(model, particles, filter_log_weights, block_size=None):
    """The marginal smoother's backward pass over stored clouds
    (T, N, dx) and filtered log-weights (T, N): the smoothed log-weights
    (T, N), normalized per step, equal to the filtered ones at T."""
    n = particles.shape[1]
    nb = _block_size(n, block_size)
    lw_s = filter_log_weights[-1]
    out = [lw_s]
    for t in range(particles.shape[0] - 2, -1, -1):
        args = (model, particles[t], filter_log_weights[t], particles[t + 1], lw_s)
        lw_s = (_backward_reweight_dense(*args) if nb >= n
                else _backward_reweight_blocked(*args, nb))
        out.append(lw_s)
    return torch.stack(out[::-1])


def smoothed_marginals(generator, model, n: int, y, config: PFConfig = PFConfig(),
                       block_size=None) -> SmoothedCloud:
    """Forward-filter backward-reweighting marginal smoother: one filter
    pass storing every cloud, then the backward W_{t|T} recursion over the
    pairwise transition densities, O(T·N²) work.

    ``block_size``: the backward pass's row-block width. ``None`` picks
    dense (N, N) tiles up to N = 2048 and blocks of 1024 above; an explicit
    divisor of N forces a width, ``block_size=n`` the dense route."""
    _block_size(n, block_size)
    xs, lw, log_z = forward_clouds(generator, model, n, y, config)
    return SmoothedCloud(xs, backward_reweight(model, xs, lw, block_size), lw, log_z)


def smoothed_mean(out: SmoothedCloud):
    """(T, dx) smoothed posterior mean E[x_t | y_{1:T}]."""
    return torch.einsum("tn,tnd->td", torch.exp(out.log_weights), out.particles)


# ---------------------------------------------------------------------------
# backward sampling (trajectories)
# ---------------------------------------------------------------------------

def _categorical(generator, logits, p: int):
    """p draws of the index along dim 0 of ``logits`` (N, *B), independently
    for each trailing batch entry, by the inverse CDF of one uniform each:
    (p, *B) int64."""
    n, batch = logits.shape[0], tuple(logits.shape[1:])
    w = torch.exp(logits - torch.amax(logits, dim=0, keepdim=True))
    u = torch.rand(batch + (p,), generator=generator, device=logits.device, dtype=logits.dtype)
    idx = _inverse_cdf(u.reshape(-1, p), w.movedim(0, -1).reshape(-1, n))
    return idx.reshape(batch + (p,)).movedim(-1, 0).long()


def _sample_paths(generator, xs, lw, model, p: int):
    """Backward sampling of p trajectories from stored clouds xs (T, N, *B,
    dx) and filtered log-weights lw (T, N, *B): (T, p, *B, dx). ``model``'s
    distributions take states (..., *B, dx): one θ's model for B = (), a
    θ-cloud's for B = (M,)."""
    def take(x_t, idx):  # x_t[idx[q, b], b] for every path q and batch entry b
        index = idx[..., None].expand(idx.shape + (x_t.shape[-1],))
        return torch.gather(x_t, 0, index)

    x_next = take(xs[-1], _categorical(generator, lw[-1], p))
    out = [x_next]
    for t in range(xs.shape[0] - 2, -1, -1):
        # log P(i) = log w_t^i + log f(x_{t+1}^(path) | x_t^i): (p, N, *B)
        logits = lw[t] + model.transition_distribution(xs[t]).log_prob(x_next[:, None])
        idx = _categorical(generator, logits.movedim(1, 0), 1)[0]
        x_next = take(xs[t], idx)
        out.append(x_next)
    return torch.stack(out[::-1])


def sample_smoothed_paths(generator, out: SmoothedCloud, model, m: int):
    """Backward-sampling FFBS: ``m`` joint trajectories x_{1:T} from the
    forward clouds and filtered weights stored in ``out``: the endpoint from
    the filtered weights at T, then backward P(i) ∝ w_t^i ·
    f(x_{t+1}^(path) | x_t^i). Returns (T, m, dx)."""
    return _sample_paths(generator, out.particles, out.filter_log_weights, model, m)


def posterior_smoothed_paths(generator, model_fn, theta, log_omega, y, n: int,
                             n_theta: int = 16, n_paths: int = 32,
                             config: PFConfig = PFConfig()):
    """θ-posterior-mixture trajectories: ``n_theta`` θ drawn from the
    weights ω of an SMC² or IBIS θ-cloud (``theta`` (M, dθ), ``log_omega``
    (M,)), a forward filter of ``n`` particles and ``n_paths``
    backward-sampled trajectories for each, pooled. The JAX package runs
    the n_theta filters one after another; here they are one
    (n_theta, N) bank through the batched filter, and the backward sampling
    is batched over θ too. Returns (T, n_theta·n_paths, dx), θ-major."""
    idx = _categorical(generator, log_omega, n_theta)
    models = model_fn(theta[idx])
    xs, lw, _ = _forward_bank(generator, models, n, n_theta, y, _config(config))
    paths = _sample_paths(generator, xs.transpose(1, 2), lw.transpose(1, 2), models, n_paths)
    return paths.transpose(1, 2).reshape(y.shape[0], n_theta * n_paths, -1)
