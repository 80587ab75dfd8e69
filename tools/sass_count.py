#!/usr/bin/env python3
"""Holds the per-particle work that ``chip_smoke.py``'s bound counts for the
propagate functions (``chip_smoke.propagate_work``, derived from the
functions) against the machine code of the kernels that compute them.

    python3 tools/sass_count.py [--out sass_count.json]

Builds the CUDA library (``kernels/_build.py``) and compiles the fused
propagate kernel (Triton) for each instance and route, disassembles each with
``cuobjdump -sass`` and counts, per particle, the instructions of the path a
particle takes. Every route gives a thread 4 particles, so a count per
particle is the thread's count over 4:

- straight-line kernels (the raw route; the normalized route up to 1024
  particles): the whole function;
- loop kernels (the normalized route above 1024): the body of the pass-1
  loop, the longest backward branch;
- in both, not a slow path: code that a conditional forward branch to a
  reconvergence point (BSYNC) skips, that loops, uses local memory or calls
  a subroutine, and that holds no MUFU operation and no global store. These
  are the math library's slow sin/cos reduction (Payne–Hanek, for |θ| ≥
  105615, which no particle takes: θ = 2πu < 2π) and its rare-input paths
  of sqrt and division, whose subroutines are not counted either. K6 is
  counted on its 16-byte route.

Counted: issued instructions; 32-bit multiplies (IMAD.WIDE two, a 64-bit
product, IMAD.HI and IMAD one; not the pipe's moves, shifts and adds), and
among them Philox's (those by its round constants); MUFU operations. Each
kernel's line gives the function's counts beside its own and whether the
kernel's issued instructions, multiplies and MUFU operations are each at least
the function's, as a least-work count must be. Prints one JSON object and
writes it to ``--out``. Needs a CUDA device, nvcc, cuobjdump and Triton.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

_INSN = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_IMM = re.compile(r"(-?)0x([0-9a-f]+)")
PHILOX_ROUND = (0xD2511F53, 0xCD9E8D57)
PARTICLES_PER_THREAD = 4


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("cuobjdump"), os.path.join(home, "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


def sass(path: str) -> dict:
    """{function name: [(address, instruction)]} of a cubin or shared library."""
    text = subprocess.run([cuobjdump(), "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _opcode(ins: str) -> str:
    toks = ins.split()
    return toks[1] if toks[0].startswith("@") else toks[0]


def _target(ins: str) -> int:
    return int(re.search(r"0x([0-9a-f]+)\s*$", ins).group(1), 16)


def _multiplies(op: str) -> int:
    """32-bit multiplies of one IMAD-family instruction."""
    if op.startswith("IMAD.WIDE"):
        return 2
    return 1 if op.startswith("IMAD.HI") or op in ("IMAD", "IMAD.U32") else 0


def _philox(ins: str) -> bool:
    """Whether an immediate operand is one of Philox's round constants."""
    return any((-int(h, 16) if neg else int(h, 16)) % 2**32 in PHILOX_ROUND
               for neg, h in _IMM.findall(ins))


def count(code, loop: bool, particles: int = PARTICLES_PER_THREAD) -> dict:
    """Per-particle counts of one function (see the module's docstring);
    ``loop``: count the longest loop's body, which takes ``particles``
    particles a thread an iteration."""
    calls = {_target(ins) for _, ins in code if _opcode(ins).startswith("CALL")}
    returns = [a for a, ins in code if _opcode(ins).startswith("RET")]
    callees = [(t, min(r for r in returns if r >= t)) for t in calls]
    code = [(a, ins) for a, ins in code if not any(lo <= a <= hi for lo, hi in callees)]
    if loop:
        lo, hi = max(((_target(ins), a) for a, ins in code
                      if _opcode(ins) == "BRA" and _target(ins) < a), key=lambda r: r[1] - r[0])
        code = [(a, ins) for a, ins in code if lo <= a <= hi]
    syncs = {a for a, ins in code if _opcode(ins) == "BSYNC"}
    slow = [a for a, ins in code if _opcode(ins).startswith(("LDL", "STL", "CALL"))
            or _opcode(ins) == "BRA" and _target(ins) < a]
    work = [a for a, ins in code if _opcode(ins).startswith(("MUFU", "STG"))]
    skipped = [(a, _target(ins)) for a, ins in code
               if ins.startswith("@") and _opcode(ins) == "BRA" and a < _target(ins)
               and _target(ins) in syncs and any(a < x < _target(ins) for x in slow)
               and not any(a < x < _target(ins) for x in work)]
    c = collections.Counter()
    for a, ins in code:
        op = _opcode(ins)
        if op == "NOP" or any(lo < a < hi for lo, hi in skipped):
            continue
        c["issue"] += 1
        c["mul"] += _multiplies(op)
        c["philox_mul"] += _multiplies(op) if _philox(ins) else 0
        c["mufu"] += op.startswith("MUFU")
    return {k: c[k] / particles for k in ("issue", "mul", "philox_mul", "mufu")}


def held(kernel: dict, model: str, s: int, carry: bool, normalize: bool, n: int) -> dict:
    """The kernel's counts beside the function's, and whether each is at
    least the function's."""
    issue, mul, mufu = cs.propagate_work(model, s, carry, normalize, n)
    fn = {"issue": issue, "mul": mul, "mufu": mufu}
    return {"kernel": kernel, "function": fn,
            "kernel_at_least_function": all(kernel[k] >= v for k, v in fn.items())}


def k6_counts() -> dict:
    """K6's three kernels, 16-byte route."""
    from sequential_monte_carlo_tpu_torch.kernels import _build

    _build.library()
    funcs = sass(str(_build.library_path()))
    out = {}
    for route, kernel, normalize, n in (("raw", "ucsv_raw_kernel", False, 8192),
                                        ("norm", "ucsv_norm_kernel", True, 1024),
                                        ("norm_loop", "ucsv_norm_loop_kernel", True, 8192)):
        (name,) = [f for f in funcs if f"{len(kernel)}{kernel}ILb1E" in f]
        out[route] = held(count(funcs[name], loop=normalize and n > 1024), "ucsv", 3, False,
                          normalize, n)
    return out


def k2_counts(torch) -> dict:
    """K2 per instance (with the carry on LG dx=1) and route, compiled as the
    wrapper launches it."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.kernels.propagate import (
        SPLIT_TILE,
        STAGES,
        _launch_config,
        _triton_kernels,
    )
    from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE

    k = _triton_kernels()
    y = torch.tensor(0.6, device="cuda")
    seed = torch.tensor([1], device="cuda")
    out, tmp = {}, tempfile.mkdtemp()
    for name in ("ucsv", "lg1", "lg1_carry", "lg2", "sv"):
        for route, normalize, n in (("raw", False, 8192), ("norm", True, 1024),
                                    ("norm_loop", True, 8192)):
            has_carry = name.endswith("carry")
            if route == "raw" and has_carry:
                continue
            m = 512
            if name == "ucsv":
                update = UCSV_UPDATE
                params = torch.tensor((0.3, 0.2), device="cuda").expand(m, 2).contiguous()
            elif name == "sv":
                model = smc.sv_model(torch.tensor([-1.0, 0.95, 0.3], device="cuda").expand(m, 3))
                update, params = model.update, model.fused_params()
            else:
                model = cs._lg_cloud(torch, smc, m, int(name[2]))
                update, params = model.update, model.fused_params()
            s = 3 if name == "ucsv" else update.n_normals
            state = torch.randn((m, s, n), device="cuda")
            new = torch.empty_like(state)
            ln = torch.empty((m, n), device="cuda")
            carry = torch.zeros((m, n), device="cuda") if has_carry else ln
            lse = torch.empty((m, 1), device="cuda") if normalize else ln
            ess = torch.empty((m, 1), device="cuda") if normalize else ln
            block, block2, tiles, warps, loop = _launch_config(n, normalize)
            compiled = k.step[(m, tiles)](
                params, state, new, carry, ln, lse, ess, y, seed, ln, ln, 0, 0, n,
                state.stride(0), 1,
                P=params.shape[1], S=s, UPDATE=getattr(k, update.triton),
                N_NORMALS=update.n_normals, HAS_CARRY=has_carry,
                NORMALIZE=normalize, LOOP=loop, BLOCK=block, BLOCK2=block2, STAGES=STAGES,
                SPLIT=False, TILE=SPLIT_TILE, TILES_P2=1, num_warps=warps)
            path = os.path.join(tmp, f"{name}_{route}.cubin")
            with open(path, "wb") as f:
                f.write(compiled.asm["cubin"])
            (code,) = sass(path).values()
            out.setdefault(name, {})[route] = held(count(code, loop), name.split("_")[0], s,
                                                   has_carry, normalize, n)
    torch.cuda.synchronize()
    shutil.rmtree(tmp)
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="sass_count.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sass_count: needs a CUDA device")
    res = {"device": torch.cuda.get_device_name(0), "k6": k6_counts(), "k2": k2_counts(torch)}
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
