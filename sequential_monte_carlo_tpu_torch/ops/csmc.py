"""Conditional SMC (L2) — counterpart of
``sequential_monte_carlo_tpu/ops/csmc.py``: the particle-filter kernel that
leaves p(x_{1:T} | y_{1:T}, θ) invariant for any N ≥ 2 (Andrieu, Doucet &
Holenstein 2010, §2.4), behind particle Gibbs.

Slot 0 carries the reference trajectory. Each step:

- the free slots' ancestors by conditional multinomial resampling (iid
  inverse-CDF draws, ``ops/resampling.py``), slot 0's ancestor 0, or with
  ancestor sampling (PGAS, Lindsten, Jordan & Schön 2014) a draw from
  w_{t−1} · f(ref_t | x_{t−1}); a gather (plain tensor code, as in the JAX
  package);
- propagate + reweight by the model's raw kernel route
  (``fused_propagate_reweight(..., normalize=False)``: K6 on UC-SV, K2 raw
  on LG and SV), or for a model without a kernel (a DSL model) by plain
  tensor code over its distributions (``batched_filter.propagate_reweight``),
  on the one-row θ-cloud of the lifted model;
- slot 0's state overwritten with ref_t and its log-weight with
  g(y_t | ref_t), evaluated in torch (the kernel wrote both for its own
  draw), then the normalize.

The new trajectory is drawn by backward sampling over the stored clouds
(``method="bs"``) or by tracing the ancestral lineage of a terminal draw
(``method="as"``, with ancestor sampling in the forward pass).

The steps run on an M-row bank, each row with its own model row and
reference path: the per-θ ``csmc_forward`` and ``csmc_sweep`` are its one-row
case, and particle Gibbs runs independent chains as the rows of one bank.

On the card a whole sweep (the init, the T − 1 steps and the path draw)
replays one captured CUDA graph (``ops/graphs.py``, the counterpart of the
JAX package's scans over t), where ``batched_filter.captures`` admits the
bank at the multinomial scheme; eagerly elsewhere and inside
``disable_graphs()``, with the same bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.base import broadcast_model
from . import batched_filter, graphs
from .batched_filter import _draws, _gather, kernel_params, propagate_reweight
from .particle_filter import PFConfig
from .resampling import _inverse_cdf
from .smoothing import SmoothedCloud, _categorical, _sample_paths
from .weights import log_normalize

__all__ = ["CSMCOut", "csmc_forward", "csmc_sweep"]

_MULTINOMIAL = PFConfig("multinomial")


class CSMCOut(NamedTuple):
    path: torch.Tensor  # (T, dx) — the freshly drawn trajectory
    cloud: SmoothedCloud  # forward clouds + filtered weights
    ancestors: torch.Tensor  # (T-1, N) int32 ancestor indices
    log_z: torch.Tensor  # scalar: the conditional filter's log Z estimate


def _ref_log_g(bank, y, ref):
    """g(y_t | ref_t) of the bank's rows' reference paths ``ref`` (T, M, dx)
    at every t, (T, M), as torch evaluates the observation density."""
    return bank.observation_distribution(ref).log_prob(y[:, None])


def _csmc_step_from_draws(u, v, seed_or_normals, bank, cloud, log_w, y, ref, ref_log_g,
                          params=None):
    """One conditional step of an M-row bank from its draws: u (M, N)
    uniforms of the free slots' multinomial ancestors, v (M, 1) the PGAS
    uniforms (None: slot 0's ancestor is 0), the propagate's Philox seed or
    normals (the generator for a model without a kernel). ``cloud``
    (M, dx, N), ``log_w`` (M, N) normalized, ``ref`` the
    rows' reference states at this step (M, dx), ``ref_log_g`` their
    g(y | ref) (M,) (:func:`_ref_log_g`). Returns (new cloud, raw
    log-weights (M, N) with slot 0's g(y | ref), ancestors (M, N) int32)."""
    anc = _inverse_cdf(u, torch.exp(log_w))
    if v is not None:
        # PGAS: slot 0's ancestor ∝ w_{t−1} · f(ref_t | x_{t−1})
        log_as = log_w + bank.transition_distribution(cloud.permute(2, 0, 1)).log_prob(ref).T
        anc[:, :1] = _inverse_cdf(v, torch.exp(log_as - torch.amax(log_as, -1, keepdim=True)))
    else:
        anc[:, 0] = 0
    new, logw = propagate_reweight(bank, y, _gather(cloud, anc), seed_or_normals, params)
    new[:, :, 0] = ref
    logw[:, 0] = ref_log_g
    return new, logw, anc


def _csmc_forward_bank(generator, bank, n: int, y, ref, ancestor_sampling: bool = False,
                       params=None):
    """The conditional forward pass of every row of an M-row bank, row m's
    slot 0 pinned to ``ref[:, m]`` (ref (T, M, dx)): (particles
    (T, M, N, dx), normalized log-weights (T, M, N), ancestors (T−1, M, N)
    int32, log Z (M,)). ``params``: the bank's kernel parameters, packed
    here when not given."""
    m = ref.shape[1]
    if params is None:
        params = kernel_params(bank)
    x = bank.initial_distribution().sample(generator, (n,))  # (N, M, dx)
    x[0] = ref[0]
    logz, log_w, _ = log_normalize(bank.observation_distribution(x).log_prob(y[0]).T)
    cloud = x.permute(1, 2, 0).contiguous()
    clouds, lws, ancs = [cloud], [log_w], []
    ref_log_g = _ref_log_g(bank, y, ref)
    for t in range(1, y.shape[0]):
        u, rest = _draws(generator, bank, m, n, cloud.device, _MULTINOMIAL)
        v = (torch.rand((m, 1), generator=generator, device=cloud.device)
             if ancestor_sampling else None)
        cloud, logw, anc = _csmc_step_from_draws(u, v, rest, bank, cloud, log_w, y[t], ref[t],
                                                 ref_log_g[t], params)
        lse = torch.logsumexp(logw, dim=-1, keepdim=True)
        log_w = logw - lse
        logz = logz + lse[:, 0] - math.log(n)
        clouds.append(cloud)
        lws.append(log_w)
        ancs.append(anc)
    return torch.stack(clouds).transpose(-1, -2), torch.stack(lws), torch.stack(ancs), logz


def _trace_lineage(generator, xs, lw, ancestors):
    """Each row's ancestral path of a terminal index drawn from its
    filtered weights at T: (T, M, dx) from xs (T, M, N, dx), lw (T, M, N),
    ancestors (T−1, M, N)."""
    b = _categorical(generator, lw[-1].T, 1).T  # (M, 1)
    idx = [b]
    for t in range(ancestors.shape[0] - 1, -1, -1):
        b = ancestors[t].gather(1, b).long()
        idx.append(b)
    idx = torch.stack(idx[::-1])  # (T, M, 1)
    return torch.gather(xs, 2, idx[..., None].expand(idx.shape + (xs.shape[-1],)))[:, :, 0]


def _csmc_eager(generator, bank, n: int, y, ref, ancestor_sampling: bool, draw, params=None):
    """The conditional forward pass of an M-row bank (PGAS with
    ``ancestor_sampling``) and, with ``draw``, each row's fresh path:
    backward sampling over the stored clouds ("bs") or the traced lineage
    ("as"). Returns (paths (T, M, dx) or None, (particles, log-weights,
    ancestors, log Z)): the body the CSMC route captures."""
    fwd = _csmc_forward_bank(generator, bank, n, y, ref, ancestor_sampling, params)
    xs, lw, anc, _ = fwd
    if draw == "bs":
        paths = _sample_paths(generator, xs.transpose(1, 2), lw.transpose(1, 2), bank, 1)[:, 0]
    elif draw == "as":
        paths = _trace_lineage(generator, xs, lw, anc)
    else:
        paths = None
    return paths, fwd


def _csmc_bank(generator, bank, n: int, y, ref, ancestor_sampling: bool, draw):
    """:func:`_csmc_eager` on the card replayed whole from one CUDA graph
    where the route is captured (``batched_filter.captures`` at the
    multinomial scheme: any model, a DSL model's plain propagate route
    too, outside :func:`.graphs.disable_graphs`; ``graphs.csmc_sweep``),
    else eagerly."""
    if y.shape[0] > 1 and batched_filter.captures(_MULTINOMIAL, None, ref.device):
        return graphs.csmc_sweep(generator, bank, n, y, ref, ancestor_sampling, draw, _csmc_eager)
    return _csmc_eager(generator, bank, n, y, ref, ancestor_sampling, draw)


def csmc_forward(generator, model, n: int, y, ref_path, ancestor_sampling: bool = False):
    """Conditional bootstrap-filter forward pass with slot 0 pinned to
    ``ref_path`` (T, dx); with ``ancestor_sampling`` slot 0's ancestor is
    redrawn each step (PGAS). The one-row bank of the lifted model.

    Returns (SmoothedCloud, ancestors (T−1, N) int32). The cloud's
    ``filter_log_weights`` are the per-step normalized conditional-filter
    weights; ``log_z`` accumulates the incremental evidence (a diagnostic:
    CSMC's is not an unbiased log Z)."""
    _, (xs, lw, anc, logz) = _csmc_bank(generator, broadcast_model(model), n, y,
                                        ref_path[:, None], ancestor_sampling, None)
    return SmoothedCloud(xs[:, 0], lw[:, 0], lw[:, 0], logz[0]), anc[:, 0]


def csmc_sweep(generator, model, n: int, y, ref_path, method: str = "bs") -> CSMCOut:
    """One CSMC kernel application, ``ref_path`` → a fresh trajectory: the
    forward pass without ancestor sampling and a backward-sampled path
    (``method="bs"``), or the PGAS forward pass and the traced lineage
    (``"as"``)."""
    if method not in ("bs", "as"):
        raise ValueError(f"unknown method {method!r}; one of ['bs', 'as']")
    paths, (xs, lw, anc, logz) = _csmc_bank(generator, broadcast_model(model), n, y,
                                            ref_path[:, None], method == "as", method)
    cloud = SmoothedCloud(xs[:, 0], lw[:, 0], lw[:, 0], logz[0])
    return CSMCOut(path=paths[:, 0], cloud=cloud, ancestors=anc[:, 0], log_z=cloud.log_z)
