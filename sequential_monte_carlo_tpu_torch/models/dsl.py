"""Declarative model-construction DSL (L1) — counterpart of
``sequential_monte_carlo_tpu/models/dsl.py``, the reference's ``@model``
macro (macros.jl:28-145): a builder that takes three density functions over
*named* states and parameters and produces a model with a fixed state
layout.

Example (the macro docstring's UC-SV program, macros.jl:9-26)::

    ucsv = ssm_model(
        "ucsv",
        params=("gamma", "sx0", "sy0"),
        defaults=dict(x0=0.0),
        init=lambda p: dict(
            x=Normal(p["x0"], torch.exp(0.5 * p["sx0"])),
            sx=Normal(p["sx0"], p["gamma"]),
            sy=Normal(p["sy0"], p["gamma"]),
        ),
        transition=lambda p, prev: dict(     # prev[...] plays @prev(...)
            x=Normal(prev["x"], torch.exp(0.5 * prev["sx"])),
            sx=Normal(prev["sx"], p["gamma"]),
            sy=Normal(prev["sy"], p["gamma"]),
        ),
        observe=lambda p, s: Normal(s["x"], torch.exp(0.5 * s["sy"])),
    )
    model = ucsv([0.2, -1.0, -1.0])          # positional θ, like model(θ)
    ucsv.get_parameters()  ->  ("gamma", "sx0", "sy0", "x0")
    ucsv.get_states()      ->  ("x", "sx", "sy")

Multi-state models pack the named states into a trailing (k,) axis through
:class:`TupleProduct`; single-state models keep a (1,) axis. A spec called
on an (M, k) θ gives a θ-cloud: the parameters the functions read are then
(M,) tensors, and the states they are handed (..., M), as the batched
filter's (N, M, dx) layout gives them. Numbers in the functions (``Normal(0.0,
1.0)``) become tensors of θ's dtype and device (fills on that device, not
copies from host memory), and every distribution's fields are broadcast to
one batch shape, so that each θ row draws its own states.

A DSL model has no fused kernel: the filters propagate it by plain tensor
code over these distributions, as the JAX package does outside any Pallas
kernel, while the resample stays on its kernel. On the card the loops replay
that code from CUDA graphs (``ops/graphs.py``), as JAX jits it: a function
that reads the host (``float(p["a"])``, ``if p["a"] > 0:``) raises
``graphs.CaptureError`` naming it at capture. ``linear_ssm_model``
declares a linear-Gaussian model and returns the port's
:class:`LinearGaussianModel`, which has the fused kernel, the Kalman filter
and IBIS.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import torch

from ..distributions import Product, TupleProduct
from ..distributions.core import _as_like
from ..utils.struct import struct


def _tensor_fields(dist, batch, like: torch.Tensor, trailing: bool = False):
    """``dist`` with every field a tensor of ``like``'s dtype and device
    (a number a fill on that device, :func:`~..distributions.core._as_like`),
    broadcast to ``batch`` (the shape of its fields, θ's batch shape and the
    states' batch shape, broadcast), and with ``trailing`` a trailing
    length-1 component axis (a single-state model's)."""
    vals = {f.name: _as_like(getattr(dist, f.name), like) for f in dataclasses.fields(dist)}
    batch = torch.broadcast_shapes(batch, *(v.shape for v in vals.values()))
    return dataclasses.replace(dist, **{
        k: (v.expand(batch)[..., None] if trailing else v.expand(batch))
        for k, v in vals.items()})


@struct
class DSLModel:
    """Model generated by :func:`ssm_model`: θ is its one tensor field, of
    shape (n_params,) or (M, n_params) in spec order (defaults appended)."""

    theta: torch.Tensor
    name: str = "model"
    param_names: tuple = ()
    state_names: tuple = ()
    init_fn: Callable = None
    transition_fn: Callable = None
    observe_fn: Callable = None

    @property
    def state_dim(self) -> int:
        return len(self.state_names)

    def _params(self) -> Mapping[str, torch.Tensor]:
        return {n: self.theta[..., i] for i, n in enumerate(self.param_names)}

    def _states(self, x) -> dict:
        return {n: x[..., i] for i, n in enumerate(self.state_names)}

    def _pack(self, dists_by_name, batch):
        dists = [dists_by_name[n] for n in self.state_names]
        batch = torch.broadcast_shapes(batch, self.theta.shape[:-1])
        if len(dists) == 1:
            return Product(_tensor_fields(dists[0], batch, self.theta, trailing=True))
        return TupleProduct(tuple(_tensor_fields(d, batch, self.theta) for d in dists))

    def _built(self, fn, role: str, build):
        """``build()``, which calls the model's function ``fn``; inside a
        CUDA-graph capture, a host read in it (``float(p["a"])``, ``if
        p["a"] > 0:``, a number copied to the card) raises
        ``graphs.CaptureError`` naming ``fn``, as JAX's jit refuses it."""
        try:
            return build()
        except RuntimeError as err:
            from ..ops.graphs import capture_error  # the ops layer sits above the models'
            name = getattr(fn, "__qualname__", fn)
            refusal = capture_error(err, f"the {role} function {name!r} of the DSL model"
                                    f" {self.name!r}", self.theta.device)
            if refusal is None:
                raise
            raise refusal from err

    def initial_distribution(self):
        return self._built(self.init_fn, "init",
                           lambda: self._pack(self.init_fn(self._params()), ()))

    def transition_distribution(self, x):
        return self._built(self.transition_fn, "transition", lambda: self._pack(
            self.transition_fn(self._params(), self._states(x)), x.shape[:-1]))

    def observation_distribution(self, x):
        batch = torch.broadcast_shapes(x.shape[:-1], self.theta.shape[:-1])
        return self._built(self.observe_fn, "observe", lambda: _tensor_fields(
            self.observe_fn(self._params(), self._states(x)), batch, self.theta))


class ModelSpec:
    """Constructor object returned by :func:`ssm_model` — callable on θ."""

    def __init__(self, name, params, defaults, states, init, transition, observe):
        self.name = name
        self._free_params = tuple(params)
        self._defaults = dict(defaults or {})
        self._param_names = self._free_params + tuple(self._defaults)
        self._state_names = tuple(states)
        self._init = init
        self._transition = transition
        self._observe = observe

    # ≡ get_parameters / get_states generated by the macro (macros.jl:130-136)
    def get_parameters(self):
        return self._param_names

    def get_states(self):
        return self._state_names

    def __call__(self, theta, device="cuda", **overrides):
        """The model at θ, (k,) or (M, k) over the free parameters: a tensor
        stays on its device, numbers go to ``device``. ``overrides`` set
        defaults by name."""
        theta = torch.as_tensor(theta, dtype=torch.float32,
                                device=theta.device if isinstance(theta, torch.Tensor) else device)
        if theta.shape[-1] != len(self._free_params):
            raise ValueError(
                f"{self.name}: expected {len(self._free_params)} free parameters "
                f"{self._free_params}, got θ of length {theta.shape[-1]}"
            )
        defaults = dict(self._defaults)
        defaults.update(overrides)
        if defaults:  # numbers as fills on θ's device: PG builds the model in its graph
            tail = torch.stack([_as_like(defaults[n], theta) for n in self._defaults])
            theta = torch.cat([theta, tail.expand(theta.shape[:-1] + tail.shape)], dim=-1)
        return DSLModel(
            theta=theta,
            name=self.name,
            param_names=self._param_names,
            state_names=self._state_names,
            init_fn=self._init,
            transition_fn=self._transition,
            observe_fn=self._observe,
        )


class _ParamRecorder(dict):
    """Probe mapping: returns a benign 0-d tensor for ANY key and records
    the access order — the Python analog of the macro's free-symbol walk
    (``extract_parameters``, macros.jl:190-213). A tensor, so that the
    functions' torch calls (``torch.exp(p["sx0"])``) take it."""

    def __init__(self, seen: list):
        super().__init__()
        self._seen = seen

    def __getitem__(self, k):
        if k not in self._seen:
            self._seen.append(k)
        return torch.tensor(0.1)

    def __contains__(self, k):  # treat every name as present
        return True


def _infer_params(init, transition, observe, states, defaults):
    """Free parameters = every name the three functions read from their
    parameter dict, in first-access order (init → transition → observe),
    minus names covered by ``defaults``."""
    seen: list = []
    rec = _ParamRecorder(seen)
    if states is None:
        states = tuple(init(rec).keys())
    else:
        init(rec)
    s_probe = {n: torch.tensor(0.1) for n in states}
    transition(rec, s_probe)
    observe(rec, s_probe)
    free = tuple(n for n in seen if n not in (defaults or {}))
    return free, tuple(states)


def ssm_model(
    name: str,
    *,
    init: Callable,
    transition: Callable,
    observe: Callable,
    params: Sequence[str] | None = None,
    defaults: Mapping[str, float] | None = None,
    states: Sequence[str] | None = None,
) -> ModelSpec:
    """Build a model constructor from three density functions.

    ``init(p) -> {state: Distribution}``; ``transition(p, prev) -> {state:
    Distribution}`` where ``prev[name]`` is the previous state (the ``@prev``
    role, macros.jl:216-226); ``observe(p, s) -> Distribution`` over y.
    State order is taken from ``states`` or from the init dict's insertion
    order.

    ``params`` may be omitted: the free parameters are then inferred by
    probing the three functions with a recording mapping, in deterministic
    first-access order. Pass the explicit list when the functions read
    parameters data-dependently (the probe sees one trace only) or to pin
    the θ layout.
    """
    if params is None:
        params, states = _infer_params(init, transition, observe, states, defaults)
    elif states is None:
        probe = init({n: torch.tensor(0.0) for n in tuple(params) + tuple(defaults or {})})
        states = tuple(probe.keys())
    return ModelSpec(name, params, defaults, states, init, transition, observe)


def _shaped(v, batch, tail, like: torch.Tensor) -> torch.Tensor:
    """A system matrix's value — a number, a per-θ scalar of shape ``batch``
    or a tensor ending in ``tail`` — as a tensor of shape batch + tail."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if tail and all(d == 1 for d in tail) and t.dim() <= len(batch):
        t = t.reshape(t.shape + (1,) * len(tail))  # one number per θ (dx = 1)
    return t.expand(batch + tail)


def linear_ssm_model(
    name: str,
    *,
    params: Sequence[str],
    A: Callable,
    B: Callable,
    Q: Callable,
    R: Callable,
    x0: Callable = None,
    sigma0: Callable = None,
):
    """Declarative LINEAR model builder — the ``@model linear`` variant,
    which the reference declares but leaves unimplemented (macros.jl:148-151).
    Each system matrix is a function of the named-parameter dict; the
    constructor returns a :class:`LinearGaussianModel` (x0 = 0 and Σ0 = I
    unless given), so the declared model gets the fused kernel, the exact
    Kalman filter and IBIS. θ is (k,) or an (M, k) θ-cloud; numbers go to
    ``device``. On a θ-cloud the parameters are (M,) tensors: a matrix
    built from one broadcasts it over its two trailing axes
    (``p["q"][..., None, None] * M``).

    Example::

        ar1 = linear_ssm_model("ar1", params=("a", "q", "r"),
                               A=lambda p: p["a"], B=lambda p: 1.0,
                               Q=lambda p: p["q"], R=lambda p: p["r"])
        model = ar1([0.5, 0.9, 0.8])     # LinearGaussianModel
    """
    from .linear_gaussian import LinearGaussianModel

    param_names = tuple(params)

    def ctor(theta, device="cuda"):
        theta = torch.as_tensor(theta, dtype=torch.float32,
                                device=theta.device if isinstance(theta, torch.Tensor) else device)
        p = {n: theta[..., i] for i, n in enumerate(param_names)}
        batch = theta.shape[:-1]
        a = torch.as_tensor(A(p), dtype=theta.dtype, device=theta.device)
        dx = 1 if a.dim() <= len(batch) else a.shape[-1]
        eye = torch.eye(dx, dtype=theta.dtype, device=theta.device)
        return LinearGaussianModel(
            A=_shaped(a, batch, (dx, dx), theta),
            B=_shaped(B(p), batch, (dx,), theta),
            Q=_shaped(Q(p), batch, (dx, dx), theta),
            R=_shaped(R(p), batch, (), theta),
            x0=_shaped(0.0 if x0 is None else x0(p), batch, (dx,), theta),
            sigma0=_shaped(eye if sigma0 is None else sigma0(p), batch, (dx, dx), theta),
        )

    ctor.__name__ = name
    ctor.get_parameters = lambda: param_names
    return ctor
