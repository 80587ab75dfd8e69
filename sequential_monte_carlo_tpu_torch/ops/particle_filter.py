"""Particle filters at one θ (L2) — counterpart of
``sequential_monte_carlo_tpu/ops/particle_filter.py``: ``pf_init``,
``pf_step``, ``log_likelihood(_masked)``, ``apf_step``,
``apf_log_likelihood`` and ``filter_sequence``, with ``PFConfig`` and
``Proposal``.

The per-θ filter is the batched filter (``ops/batched_filter.py``) at one
row, not a second implementation: the model is lifted to a one-row θ-cloud
(:func:`~sequential_monte_carlo_tpu_torch.models.base.broadcast_model`), the
batched init and step run on it, and the row axis is dropped on the way out,
so particles come back as (N, dx) and log-weights as (N,), as in the JAX
package. On a GPU every step therefore runs the batched layer's kernels at
M = 1: K1 (systematic) or K3 (stratified) and the model's fused propagate,
normalized (K2) or, for the auxiliary filter, raw (K2 raw, K6 on UC-SV). A
proposal is called with the lifted model and states laid out (..., 1, dx).

As in the JAX package, ``PFConfig.algorithm`` belongs to the batched layer:
``pf_step`` is the bootstrap or guided step whatever it says, and
``apf_step`` the auxiliary one. Where the JAX package scans over T with
split keys, these functions loop over T drawing from one explicit
``torch.Generator``; on the card, where the route is captured, the loops
of ``log_likelihood(_masked)``, ``apf_log_likelihood`` and
``filter_sequence`` replay CUDA graphs (``ops/graphs.py``), bit for bit the
eager loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models.base import broadcast_model

__all__ = [
    "PFConfig",
    "PFStepOut",
    "ParticleState",
    "Proposal",
    "apf_log_likelihood",
    "apf_step",
    "filter_sequence",
    "log_likelihood",
    "log_likelihood_masked",
    "pf_init",
    "pf_step",
]


class Proposal(NamedTuple):
    """Guided-filter proposal: q0(model) and q(model, x_prev), each a
    distribution over the state. The batched filter calls them with the
    θ-cloud's model and states laid out (..., M, dx), as the models'
    own distribution methods take them."""

    initial: Callable  # model -> distribution over x_1
    step: Callable  # (model, x_prev (..., M, dx)) -> distribution over x_t


class PFConfig(NamedTuple):
    """Static filter configuration. The JAX package's TPU routing field
    ``fused_resample`` has no counterpart: the port has one route per
    device. ``mesh`` (JAX's field) is the (theta, particle) mesh of a
    sharded run (``parallel.make_mesh``): the batched filter then holds
    this rank's rows of the bank and, where the mesh shards particles, its
    particles of each row (``ops/batched_filter.py``)."""

    resampling: str = "systematic"
    ess_threshold: float = 1.0  # resample when ESS < τ·N; 1.0 ≡ every step
    proposal: object = None  # a Proposal for the guided filter; None = bootstrap
    algorithm: str = "bootstrap"  # or "apf"
    mesh: object = None  # a DeviceMesh: θ over its theta axis, particles over the other


class ParticleState(NamedTuple):
    particles: torch.Tensor  # (N, dx)
    log_weights: torch.Tensor  # (N,) normalized: logsumexp == 0


class PFStepOut(NamedTuple):
    state: ParticleState
    log_mean: torch.Tensor  # incremental evidence log p̂(y_t | y_{1:t-1})
    ess: torch.Tensor  # ESS of the post-reweight normalized weights


# The batched layer imports PFConfig from here, so it is imported after it.
from . import batched_filter as _bf  # noqa: E402
from . import graphs  # noqa: E402


def _config(config: PFConfig, proposal=None, algorithm: str = "bootstrap") -> PFConfig:
    """The batched layer's config for a per-θ call: the proposal argument
    over ``config.proposal``, and the per-θ function's algorithm."""
    proposal = config.proposal if proposal is None else proposal
    if algorithm == "apf":  # the lookahead resamples every step and replaces a proposal
        return config._replace(ess_threshold=1.0, proposal=None, algorithm="apf")
    return config._replace(proposal=proposal, algorithm=algorithm)


def _row(out) -> PFStepOut:
    """Row 0 of a one-row batched output."""
    return PFStepOut(ParticleState(out.particles[0], out.log_weights[0]), out.log_mean[0],
                     out.ess[0])


def _step(generator, bank, state: ParticleState, y, config: PFConfig, params=None) -> PFStepOut:
    return _row(_bf.batched_pf_step(generator, bank, state.particles[None],
                                    state.log_weights[None], y, config, params))


def pf_init(generator, model, n: int, y0, proposal: Optional[Proposal] = None) -> PFStepOut:
    """N draws from the initial distribution (or from ``proposal.initial``),
    weighted by the observation density at y0 (times p(x)/q0(x) with a
    proposal)."""
    config = _config(PFConfig(), proposal)
    return _row(_bf.batched_pf_init(generator, broadcast_model(model), n, 1, y0, config))


def pf_step(generator, model, state: ParticleState, y, config: PFConfig = PFConfig(),
            proposal: Optional[Proposal] = None) -> PFStepOut:
    """One filter step: resample (every step, or when the ESS fell below
    ``config.ess_threshold``·N), propagate (or draw from the proposal),
    reweight by y and normalize."""
    return _step(generator, broadcast_model(model), state, y, _config(config, proposal))


def log_likelihood(generator, model, n: int, y, config: PFConfig = PFConfig(),
                   proposal: Optional[Proposal] = None):
    """Full-sequence marginal-likelihood estimate: (final ParticleState,
    log Z)."""
    return log_likelihood_masked(generator, model, n, y, torch.ones(y.shape[0]), config,
                                 proposal)


def log_likelihood_masked(generator, model, n: int, y, mask, config: PFConfig = PFConfig(),
                          proposal: Optional[Proposal] = None):
    """log Z over the steps of y with mask > 0 (mask[0] must be 1): the
    others leave the state untouched and add no evidence. ``mask`` is read
    on the host. Returns (final ParticleState, log Z)."""
    particles, log_w, logz = _bf.batched_log_likelihood_masked(
        generator, broadcast_model(model), n, 1, y, mask, _config(config, proposal))
    return ParticleState(particles[0], log_w[0]), logz[0]


def apf_step(generator, model, state: ParticleState, y,
             config: PFConfig = PFConfig()) -> PFStepOut:
    """Auxiliary particle filter step (Pitt & Shephard 1999): resample by
    λ ∝ w·g(y | E[x′|x]) with ``config.resampling``, propagate, correct by
    g(y | x′)/g(y | μ of the ancestor). The evidence increment is
    log Σ w·g(y | μ) + log mean of the corrections."""
    return _step(generator, broadcast_model(model), state, y, _config(config, algorithm="apf"))


def apf_log_likelihood(generator, model, n: int, y, config: PFConfig = PFConfig()):
    """Full-sequence auxiliary-filter log Z (bootstrap init, then APF
    steps): (final ParticleState, log Z)."""
    particles, log_w, logz = _bf.batched_log_likelihood(
        generator, broadcast_model(model), n, 1, y, _config(config, algorithm="apf"))
    return ParticleState(particles[0], log_w[0]), logz[0]


def _stack_tree(items: list):
    """Per-step outputs — tensors, or dicts and tuples of them — stacked
    over the steps."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack_tree([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        fields = [_stack_tree(list(f)) for f in zip(*items)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    return torch.stack([torch.as_tensor(x) for x in items])


def filter_sequence(generator, model, n: int, y, config: PFConfig = PFConfig(),
                    proposal: Optional[Proposal] = None,
                    summarize: Optional[Callable] = None):
    """Filter the whole sequence, returning per-step telemetry.

    ``summarize(state) -> tensor`` (or a dict or tuple of tensors) is
    applied to the (N, dx) :class:`ParticleState` after every step, e.g.
    weighted quantiles. Returns (final state, log Z, per-step dict with
    "log_mean" (T,), "ess" (T,) and, with ``summarize``, "summary" stacked
    over T).

    On the card, where the route is captured (``batched_filter.captures``),
    the steps replay CUDA graphs (``ops/graphs.py``) that store each step's
    outputs, ``summarize``'s included: it is captured inside the step, as the
    JAX package traces it into its scan, so it must be capturable — device
    tensor code that reads nothing from the host (no ``.item()``, no tensor
    made from Python numbers on the device). One that is not raises
    ``graphs.CaptureError``, naming it; ``disable_graphs()`` runs the eager
    loop, bit for bit the same."""
    config = _config(config, proposal)
    bank = broadcast_model(model)
    params = _bf.kernel_params(bank, config)

    def emit(out: PFStepOut) -> dict:
        d = {"log_mean": out.log_mean, "ess": out.ess}
        if summarize is not None:
            d["summary"] = summarize(out.state)
        return d

    init = _bf.batched_pf_init(generator, bank, n, 1, y[0], config)
    if y.shape[0] > 1 and _bf.captures(config, None, init.log_weights.device):
        particles, log_w, _, series = graphs.filter_stored(
            generator, bank, init, params, y, config, lambda o: emit(_row(o)),
            ("filter_sequence", summarize))
        return (ParticleState(particles[0], log_w[0]), torch.sum(series["log_mean"]), series)
    out = _row(init)
    emitted = [emit(out)]
    for t in range(1, y.shape[0]):
        out = _step(generator, bank, out.state, y[t], config, params)
        emitted.append(emit(out))
    series = _stack_tree(emitted)
    return out.state, torch.sum(series["log_mean"]), series
