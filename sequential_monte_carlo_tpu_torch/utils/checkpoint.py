"""Checkpoint and resume of sampler states — counterpart of
``sequential_monte_carlo_tpu/utils/checkpoint.py``.

A state (``SMC2State``, ``IBISState``: frozen dataclasses of tensors and
host values) is written with ``torch.save`` as a plain dict — its type name,
its fields (tensors on the CPU, host ints and bools as they are) and, when
given, the ``torch.Generator``'s state — so that it loads with
``torch.load(weights_only=True)``, which refuses pickled classes: no
dataclass is pickled. With the generator's state restored, a resumed run is
bitwise the uninterrupted one. Reading goes against a template state of the
same type, as in the JAX package; each tensor comes back on the device asked
for, in the memory order of the template's tensor (an SMC² state's particles
keep their planar storage, the (M, dx, N) cloud seen as (M, N, dx), which
the kernel wrappers need), whatever its shape (an exchange step may have
doubled N since the template was made).

The JAX package's orbax variant is not ported: ``torch.save`` covers one
card, and a multi-host checkpoint waits for the port's ``parallel``.
"""
from __future__ import annotations

import dataclasses
import os

import torch


def save_checkpoint(path: str, state, generator: torch.Generator | None = None) -> None:
    """Write ``state`` (a sampler-state dataclass) and, when given, the
    generator's state to ``path``."""
    fields = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        fields[f.name] = v.detach().cpu() if isinstance(v, torch.Tensor) else v
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"type": type(state).__name__, "fields": fields,
                "generator": None if generator is None else generator.get_state()}, path)


def _in_layout_of(v: torch.Tensor, like: torch.Tensor, device) -> torch.Tensor:
    """``v`` on ``device``, laid out in the memory order of ``like`` (its
    dimensions ordered by stride, outermost first)."""
    if v.dim() != like.dim():
        return v.to(device)
    order = sorted(range(like.dim()), key=lambda d: -like.stride(d))
    out = torch.empty([v.shape[d] for d in order], dtype=v.dtype, device=device)
    return out.permute([order.index(d) for d in range(v.dim())]).copy_(v)


def load_checkpoint(path: str, template, generator: torch.Generator | None = None,
                    device=None):
    """Restore a state saved by :func:`save_checkpoint`. ``template``: any
    state of the same type (e.g. a freshly built init state); ``device``:
    where the tensors go (default: the template's). With ``generator``, its
    state is set to the saved one."""
    data = torch.load(path, weights_only=True)
    if data["type"] != type(template).__name__:
        raise ValueError(f"checkpoint holds a {data['type']}, the template is a "
                         f"{type(template).__name__}")
    names = [f.name for f in dataclasses.fields(template)]
    if sorted(names) != sorted(data["fields"]):
        raise ValueError(f"checkpoint fields {sorted(data['fields'])} differ from the "
                         f"template's {sorted(names)}")
    if device is None:
        device = next(v.device for v in (getattr(template, n) for n in names)
                      if isinstance(v, torch.Tensor))
    restored = {}
    for name in names:
        v, like = data["fields"][name], getattr(template, name)
        restored[name] = _in_layout_of(v, like, device) if isinstance(v, torch.Tensor) else v
    if generator is not None:
        if data["generator"] is None:
            raise ValueError("checkpoint holds no generator state")
        generator.set_state(data["generator"])
    return dataclasses.replace(template, **restored)
