"""Fused propagate + reweight + per-row normalize — kernel 2 of the inner
filter step.

Counterpart of ``sequential_monte_carlo_tpu/kernels/propagate_pallas.py::
fused_elementwise_step``. For every θ-row m and particle i it draws the
model's N(0, 1) normals, applies the model's elementwise update (new state
planes and the observation log-weight), adds the optional carried
log-weights ``carry_logw`` (the adaptive-resampling route, where the
pre-propagate weights are not the constant −log N), and then normalizes each
row:

    lse_m = log Σ_i exp(logw_mi),  log_norm = logw − lse,
    ess_m = (Σ e)² / Σ e²   with e = exp(logw − max_m).

With ``normalize=False`` (the auxiliary particle filter's second stage,
which corrects the log-weights before it normalizes) the kernel stores the
raw log-weights and skips the normalize, as the JAX builder does.

The kernel is Triton (:func:`_triton_kernels`). What bounds it on the H100:
memory. It reads the cloud (and the carry), writes the new cloud and
log_norm (or the raw logw): (2S + 1 + carry)·4·M·N bytes counted once each
(UC-SV, S=3: 15 MB at M=512, N=1024, 117 MB at N=8192, 4.4 and 35 µs at
3.35 TB/s; LG dx=1 with carry: 8.4 MB at 512×1024). Design
(:func:`_launch_config`):

- A program takes 1024 particles at a time with 8 warps, 4 a thread, so
  loads and stores are 16 bytes wide where the row allows (Triton
  specializes on pointers and N divisible by 16).
- With the normalize, a row of up to 1024 particles is one program that
  keeps the row's log-weights in registers between the row reduction and
  the subtraction of lse: log_norm is written once. A longer row is one
  program that loops over it (loads two blocks ahead): pass 1 stores the
  raw log-weights, marked to stay in L2 while the streamed planes are marked
  to leave it first, with the row's running max (a scalar, so one exp a
  particle) and the rescaled Σe, Σe²; pass 2 rewrites log_norm from L2.
  Holding a row of 8192 in registers instead (one program of 16 or 32 warps,
  or 4–16 blocks kept as a tuple) measured slower on the H100: fewer rows in
  flight and spilled registers.
- Without the normalize a row is split over programs of 1024, grid
  (M, ⌈N / 1024⌉), so that many warps are in flight.
- With the normalize, a row of more than 16,384 particles (the split route)
  is split over programs of 4096, in one launch: at few rows, one program
  a row would leave most of the 132 SMs idle. Each program runs the loop
  route's pass 1 over its tile (the same draws and update), stores its
  tile's (max, Σe, Σe²) into per-row partials and takes a ticket on its
  row's counter (an atomic add, acquire-release at GPU scope); the program
  that draws a row's last ticket combines the partials in tile order (so
  the bits do not depend on which program came last), writes lse and ess
  and rewrites the row's log_norm from L2. No program waits on another.
  Rows are launched in groups whose raw log-weights fit in L2 (16 MB),
  each group's tiles in row-minor order. The wrapper hands the partials
  (``torch.empty``) and the zeroed counters (``torch.zeros``, one fill a
  call) to the kernel.
- Only the normals a model takes are computed: the second Box–Muller pair
  only for more than two (UC-SV), and an unused sine or cosine is dead code.

What holds it back now (PERF.md): at N=8192 the normalized route's pass 2
and its one program per row; the UC-SV update's Philox, Box–Muller and
exps are about as much issue time as its bytes take at the memory rate. On
the split route, the rows' last programs rewrite their rows at the end of
the launch (one SM a row, about a fifth of the launch at 64×65,536), and
pass 1 with the normalize's exps and reductions takes about a quarter more
than the route without it.

Draws are keyed by (seed, row_offset + row, particle_offset + particle
index) — Philox counters (i, row) — so they do not depend on the block size,
and a θ-sharded run (``row_offset`` = the shard's first global row) or a
particle-sharded one (``particle_offset`` = the first global particle of the
rank's slice of every row) draws what an unsharded run draws (the property
of ``propagate_pallas.py:25-27``).

The model's update is a ``@triton.jit`` function passed to the kernel as a
``tl.constexpr``, as the JAX builder takes ``update_fn``: further models
add an update function, not a kernel. The instances are UC-SV
(``models/ucsv.py``), SV (``models/stochastic_volatility.py``) and LG at
any dx (``models/linear_gaussian.py``): dx = 1 and 2 written out below, dx ≥
3 generated from the dx-generic update (:func:`_lg_source`). An update reads
its row's parameters and state planes, stores the new planes and returns the
log-weights:

    update(par, st, new, n, offs, mask, y, z0, z1, z2, z3) -> logw

with ``par`` the row's P parameters, ``st``/``new`` the row's (S, N) planes,
and z0..z3 the particle's independent N(0, 1) draws (the update's
``n_normals`` of them; with two or fewer, z2 and z3 are 0). An update that
takes more than four normals also gets ``seed, grow, ctr`` (``ctr`` the
particles' global indices) and draws the rest itself, four a Philox call at
the further counters (particle, row, k, 0), k = 1, 2, ...: normal 4k + i is
word pair i // 2's Box–Muller draw i % 2 at counter k, the order in which
the plain version takes them.

:func:`fused_elementwise_step_plain` is the same function in plain PyTorch
with the normals injected. :func:`fused_elementwise_step` takes it for CPU
tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import collections
import functools
import hashlib
import importlib.util
import os
import types
from typing import Callable, NamedTuple

import torch

from . import _build


class ElementwiseUpdate(NamedTuple):
    """A model's per-particle step in the two forms the wrapper runs."""

    plain: Callable  # (params, y, state, normals) -> (new_state, logw)
    triton: str  # the @triton.jit form: an attribute of _triton_kernels(), or lg<dx>
    n_normals: int  # N(0, 1) draws per particle


def fused_elementwise_step_plain(update: ElementwiseUpdate, params, state, y,
                                 normals, carry_logw=None, normalize: bool = True, out=None):
    """Plain version with injected normals.

    Args:
      params: (M, P) per-θ parameters; row m's become (M, 1) columns.
      state: (M, S, N) state planes.
      y: scalar observation (0-d tensor).
      normals: (n_normals, M, N) standard-normal draws.
      carry_logw: optional (M, N) log-weights added before the normalize.
      normalize: False returns the raw log-weights.
      out: optional (new state, log_norm or logw) tensors written in place.

    Returns (new state (M, S, N), log_norm (M, N), lse (M, 1), ess (M, 1)),
    or (new state, logw (M, N)) with ``normalize=False``.
    """
    par = tuple(params[:, i:i + 1] for i in range(params.shape[1]))
    planes = tuple(state[:, s] for s in range(state.shape[1]))
    new, logw = update.plain(par, y, planes, tuple(normals))
    if carry_logw is not None:
        logw = logw + carry_logw
    new = torch.stack(new, dim=1, out=None if out is None else out[0])
    if not normalize:
        return new, (logw if out is None else out[1].copy_(logw))
    log_norm, lse, ess = normalize_rows(logw)
    return new, (log_norm if out is None else out[1].copy_(log_norm)), lse, ess


def normalize_rows(logw):
    """The plain version's per-row normalize of (M, N) log-weights:
    (log_norm (M, N), lse (M, 1), ess (M, 1))."""
    mx = torch.amax(logw, dim=-1, keepdim=True)
    e = torch.exp(logw - mx)
    s = torch.sum(e, dim=-1, keepdim=True)
    lse = mx + torch.log(s)
    ess = (s * s) / torch.sum(e * e, dim=-1, keepdim=True)
    return logw - lse, lse, ess


@functools.lru_cache(maxsize=None)
def _triton_kernels() -> types.SimpleNamespace:
    """Import Triton and define the kernel and the update functions.

    Runs at first launch, never at import: hosts without a GPU have no
    Triton. The jitted functions resolve ``tl`` through this module's
    globals, which the ``global`` statement binds here. Triton's cache goes
    to the package's ``_build/`` unless ``TRITON_CACHE_DIR`` is set.
    """
    global triton, tl
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    # The streamed planes, once read or written, leave L2 first
    # ("evict_first"), so that the loop route's raw log-weights stay there
    # until its second pass

    @triton.jit
    def ucsv_update(par, st, new, n, offs, mask, y, z0, z1, z2, z3):
        # models/ucsv.py::ucsv_update, op for op
        ge = tl.load(par)
        gn = tl.load(par + 1)
        x = tl.load(st + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        lse = tl.load(st + n + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        lsn = tl.load(st + 2 * n + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        x_new = x + tl.exp(0.5 * lse) * z0
        lse_new = lse + ge * z1
        lsn_new = lsn + gn * z2
        s_inv = tl.exp(-0.5 * lsn_new)
        zz = (y - x_new) * s_inv
        logw = -0.5 * zz * zz - 0.5 * lsn_new - 0.9189385332046727  # ½log 2π
        tl.store(new + offs, x_new, mask=mask, eviction_policy="evict_first")
        tl.store(new + n + offs, lse_new, mask=mask, eviction_policy="evict_first")
        tl.store(new + 2 * n + offs, lsn_new, mask=mask, eviction_policy="evict_first")
        return logw

    @triton.jit
    def sv_update(par, st, new, n, offs, mask, y, z0, z1, z2, z3):
        # models/stochastic_volatility.py::sv_update, op for op
        mu = tl.load(par)
        phi = tl.load(par + 1)
        sigma = tl.load(par + 2)
        x = tl.load(st + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        x_new = mu + phi * (x - mu) + sigma * z0
        logw = -0.5 * (y * y) * tl.exp(-x_new) - 0.5 * x_new - 0.9189385332046727
        tl.store(new + offs, x_new, mask=mask, eviction_policy="evict_first")
        return logw

    @triton.jit
    def lg1_update(par, st, new, n, offs, mask, y, z0, z1, z2, z3):
        # models/linear_gaussian.py::_lg_update(1): params (A, F, B, R)
        a = tl.load(par)
        f = tl.load(par + 1)
        b = tl.load(par + 2)
        r = tl.load(par + 3)
        x = tl.load(st + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        x_new = a * x + f * z0
        delta = y - b * x_new
        logw = -0.5 * delta * delta / r - 0.5 * tl.log(r) - 0.9189385332046727
        tl.store(new + offs, x_new, mask=mask, eviction_policy="evict_first")
        return logw

    @triton.jit
    def lg2_update(par, st, new, n, offs, mask, y, z0, z1, z2, z3):
        # models/linear_gaussian.py::_lg_update(2): params (A row-major,
        # F row-major, B, R), F·Fᵀ = Q
        x0 = tl.load(st + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        x1 = tl.load(st + n + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        n0 = (tl.load(par) * x0 + tl.load(par + 1) * x1
              + tl.load(par + 4) * z0 + tl.load(par + 5) * z1)
        n1 = (tl.load(par + 2) * x0 + tl.load(par + 3) * x1
              + tl.load(par + 6) * z0 + tl.load(par + 7) * z1)
        r = tl.load(par + 10)
        delta = y - (tl.load(par + 8) * n0 + tl.load(par + 9) * n1)
        logw = -0.5 * delta * delta / r - 0.5 * tl.log(r) - 0.9189385332046727
        tl.store(new + offs, n0, mask=mask, eviction_policy="evict_first")
        tl.store(new + n + offs, n1, mask=mask, eviction_policy="evict_first")
        return logw

    @triton.jit
    def draw_normals(seed, ctr, grow, N_NORMALS: tl.constexpr):
        # Philox-4x32-10 at counter (particle, row, 0, 0); Box–Muller pairs,
        # the second only for models that take more than two normals
        c0 = ctr.to(tl.uint32)
        zero = c0 * 0
        r0, r1, r2, r3 = tl.philox(seed, c0, zero + grow, zero, zero)
        z0, z1 = tl.pair_uniform_to_normal(tl.uint_to_uniform_float(r0),
                                           tl.uint_to_uniform_float(r1))
        if N_NORMALS > 2:
            z2, z3 = tl.pair_uniform_to_normal(tl.uint_to_uniform_float(r2),
                                               tl.uint_to_uniform_float(r3))
        else:
            z2 = z0 * 0.0
            z3 = z2
        return z0, z1, z2, z3

    @triton.jit
    def step_kernel(par_ptr, st_ptr, new_ptr, carry_ptr, lognorm_ptr, lse_ptr,
                    ess_ptr, y_ptr, seed_ptr, part_ptr, ticket_ptr, row_offset, particle_offset,
                    n, st_row_stride, group_rows,
                    P: tl.constexpr, S: tl.constexpr, UPDATE: tl.constexpr,
                    N_NORMALS: tl.constexpr, HAS_CARRY: tl.constexpr,
                    NORMALIZE: tl.constexpr, LOOP: tl.constexpr, BLOCK: tl.constexpr,
                    BLOCK2: tl.constexpr, STAGES: tl.constexpr, SPLIT: tl.constexpr,
                    TILE: tl.constexpr, TILES_P2: tl.constexpr):
        if SPLIT:
            # program p of the 1-D grid takes one tile of one row: rows go
            # in groups of group_rows, and within a group every row's tile
            # 0, then every row's tile 1, ... (a group's raw log-weights
            # stay in L2 until its rows' last programs rewrite them)
            tiles = tl.cdiv(n, TILE)
            pid = tl.program_id(0)
            n_rows = tl.num_programs(0) // tiles
            first = (pid // (group_rows * tiles)) * group_rows
            rows = tl.minimum(group_rows, n_rows - first)
            q = pid - first * tiles
            tile = q // rows
            row = first + (q - tile * rows)
        else:
            row = tl.program_id(0)
        y = tl.load(y_ptr)
        seed = tl.load(seed_ptr)
        grow = (row + row_offset).to(tl.uint32)
        par = par_ptr + row * P
        st = st_ptr + row.to(tl.int64) * st_row_stride
        new = new_ptr + row.to(tl.int64) * S * n
        ln = lognorm_ptr + row.to(tl.int64) * n
        carry = carry_ptr + row.to(tl.int64) * n
        neg_inf = float("-inf")
        if not LOOP:
            # one tile: the whole row (the normalize), or the program's part
            # of it (no normalize, grid (M, cdiv(N, BLOCK)))
            offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            z0, z1, z2, z3 = draw_normals(seed, offs + particle_offset, grow, N_NORMALS)
            if N_NORMALS > 4:
                logw = UPDATE(par, st, new, n, offs, mask, y, z0, z1, z2, z3, seed, grow,
                              offs + particle_offset)
            else:
                logw = UPDATE(par, st, new, n, offs, mask, y, z0, z1, z2, z3)
            if HAS_CARRY:
                logw += tl.load(carry + offs, mask=mask, other=0.0, eviction_policy="evict_first")
            if NORMALIZE:
                # the row's log-weights stay in registers: log_norm written once
                logw = tl.where(mask, logw, neg_inf)
                mx = tl.max(logw, axis=0)
                e = tl.where(logw == neg_inf, 0.0, tl.exp(logw - mx))
                t1 = tl.sum(e, axis=0)
                t2 = tl.sum(e * e, axis=0)
                lse = mx + tl.log(t1)
                tl.store(lse_ptr + row, lse)
                tl.store(ess_ptr + row, (t1 * t1) / t2)
                tl.store(ln + offs, logw - lse, mask=mask)
            else:
                tl.store(ln + offs, logw, mask=mask)
        else:
            # longer rows, normalized: pass 1 stores the raw log-weights (kept
            # in L2) and the row's running max (a scalar, so one exp a
            # particle) with Σe and Σe² rescaled to it; pass 2 rewrites them,
            # BLOCK2 at a time, once lse is known
            if SPLIT:
                lo = tile * TILE
                hi = tl.minimum(lo + TILE, n)
            else:
                lo = 0
                hi = n
            m_run = tl.full((), neg_inf, tl.float32)
            s1 = tl.zeros((BLOCK,), tl.float32)
            s2 = tl.zeros((BLOCK,), tl.float32)
            for start in tl.range(lo, hi, BLOCK, num_stages=STAGES):
                offs = start + tl.arange(0, BLOCK)
                mask = offs < n
                z0, z1, z2, z3 = draw_normals(seed, offs + particle_offset, grow, N_NORMALS)
                if N_NORMALS > 4:
                    logw = UPDATE(par, st, new, n, offs, mask, y, z0, z1, z2, z3, seed, grow,
                                  offs + particle_offset)
                else:
                    logw = UPDATE(par, st, new, n, offs, mask, y, z0, z1, z2, z3)
                if HAS_CARRY:
                    logw += tl.load(carry + offs, mask=mask, other=0.0,
                                    eviction_policy="evict_first")
                logw = tl.where(mask, logw, neg_inf)
                tl.store(ln + offs, logw, mask=mask, eviction_policy="evict_last")
                m_new = tl.maximum(m_run, tl.max(logw, axis=0))
                alpha = tl.where(m_run == neg_inf, 0.0, tl.exp(m_run - m_new))
                e = tl.where(logw == neg_inf, 0.0, tl.exp(logw - m_new))
                s1 = s1 * alpha + e
                s2 = s2 * (alpha * alpha) + e * e
                m_run = m_new
            t1 = tl.sum(s1, axis=0)
            t2 = tl.sum(s2, axis=0)
            if SPLIT:
                # the tile's (max, Σe, Σe²) into the row's (3, tiles)
                # partials; the program that draws the row's last ticket
                # finishes the row. No program waits on another.
                part = part_ptr + row.to(tl.int64) * 3 * tiles
                tl.store(part + tile, m_run)
                tl.store(part + tiles + tile, t1)
                tl.store(part + 2 * tiles + tile, t2)
                # every thread's stores precede the ticket, whose release
                # (GPU scope) publishes them to the program that acquires
                # the last one
                tl.debug_barrier()
                ticket = tl.atomic_add(ticket_ptr + row, 1, sem="acq_rel", scope="gpu")
                if ticket == tiles - 1:
                    # the partials in tile order, so that the row's bits do
                    # not depend on which program came last; read from L2
                    j = tl.arange(0, TILES_P2)
                    live = j < tiles
                    pm = tl.load(part + j, mask=live, other=neg_inf, cache_modifier=".cg")
                    p1 = tl.load(part + tiles + j, mask=live, other=0.0, cache_modifier=".cg")
                    p2 = tl.load(part + 2 * tiles + j, mask=live, other=0.0,
                                 cache_modifier=".cg")
                    mx = tl.max(pm, axis=0)
                    scale = tl.where(pm == neg_inf, 0.0, tl.exp(pm - mx))
                    t1 = tl.sum(p1 * scale, axis=0)
                    t2 = tl.sum(p2 * (scale * scale), axis=0)
                    lse = mx + tl.log(t1)
                    tl.store(lse_ptr + row, lse)
                    tl.store(ess_ptr + row, (t1 * t1) / t2)
                    for start in range(0, n, BLOCK2):
                        offs = start + tl.arange(0, BLOCK2)
                        mask = offs < n
                        lw = tl.load(ln + offs, mask=mask, cache_modifier=".cg")
                        tl.store(ln + offs, lw - lse, mask=mask)
            else:
                lse = m_run + tl.log(t1)
                tl.store(lse_ptr + row, lse)
                tl.store(ess_ptr + row, (t1 * t1) / t2)
                tl.debug_barrier()  # pass 1's stores are visible to every thread
                for start in range(0, n, BLOCK2):
                    offs = start + tl.arange(0, BLOCK2)
                    mask = offs < n
                    lw = tl.load(ln + offs, mask=mask, eviction_policy="evict_first")
                    tl.store(ln + offs, lw - lse, mask=mask)

    return types.SimpleNamespace(step=step_kernel, ucsv=ucsv_update, sv=sv_update,
                                 lg1=lg1_update, lg2=lg2_update)


def _lg_source(dx: int) -> str:
    """Source of the LG update at state dimension dx ≥ 3, op for op the
    plain ``models/linear_gaussian.py::_lg_update(dx)`` (≡ the JAX package's):
    params (A row-major, F row-major, B, R) with F·Fᵀ = Q,
    x′_i = Σ_j A_ij x_j + Σ_j F_ij z_j, log w = log N(y; B·x′, R)."""
    ev = 'mask=mask, other=0.0, eviction_policy="evict_first"'
    extra = dx > 4
    lines = ["import triton", "import triton.language as tl", "", "",
             "@triton.jit",
             f"def lg{dx}_update(par, st, new, n, offs, mask, y, z0, z1, z2, z3"
             + (", seed, grow, ctr):" if extra else "):")]
    body = [f"x{j} = tl.load(st + {j} * n + offs, {ev})" for j in range(dx)]
    if extra:  # normals 4.. from the further counters (particle, row, k, 0)
        body += ["c0 = ctr.to(tl.uint32)", "zero = c0 * 0"]
        for k in range(1, (dx + 3) // 4):
            body.append(f"r0, r1, r2, r3 = tl.philox(seed, c0, zero + grow, zero + {k}, zero)")
            for pair in range(2):
                i = 4 * k + 2 * pair
                if i >= dx:
                    break
                body.append(f"z{i}, z{i + 1} = tl.pair_uniform_to_normal("
                            f"tl.uint_to_uniform_float(r{2 * pair}), "
                            f"tl.uint_to_uniform_float(r{2 * pair + 1}))")
    for i in range(dx):
        terms = [f"tl.load(par + {i * dx + j}) * x{j}" for j in range(dx)]
        terms += [f"tl.load(par + {dx * dx + i * dx + j}) * z{j}" for j in range(dx)]
        body.append(f"n{i} = " + " + ".join(terms))
    loc = " + ".join(f"tl.load(par + {2 * dx * dx + i}) * n{i}" for i in range(dx))
    body += [f"r = tl.load(par + {2 * dx * dx + dx})",
             f"delta = y - ({loc})",
             "logw = -0.5 * delta * delta / r - 0.5 * tl.log(r) - 0.9189385332046727"]
    body += [f'tl.store(new + {i} * n + offs, n{i}, mask=mask, eviction_policy="evict_first")'
             for i in range(dx)]
    body.append("return logw")
    return "\n".join(lines + ["    " + b for b in body]) + "\n"


@functools.lru_cache(maxsize=None)
def _update_fn(name: str):
    """The @triton.jit update of an instance: written out in
    :func:`_triton_kernels`, or for LG at dx ≥ 3 generated by
    :func:`_lg_source` into a module under ``_build/`` (Triton compiles a
    function from its source file) and imported."""
    k = _triton_kernels()
    if hasattr(k, name):
        return getattr(k, name)
    dx = int(name[2:])
    src = _lg_source(dx)
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    path = _build.BUILD_DIR / "triton_updates" / f"lg{dx}_{digest}.py"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(src)
        os.replace(tmp, path)  # atomic: a concurrent importer sees all or nothing
    spec = importlib.util.spec_from_file_location(f"smc_triton_lg{dx}_{digest}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, f"lg{dx}_update")


def check_out(out, state) -> None:
    """Raise unless ``out`` is None or the (new state (M, S, N), log-weights
    (M, N)) pair a propagate kernel writes: contiguous f32 on the state's
    device."""
    if out is None:
        return
    if len(out) != 2:
        raise ValueError(f"out must be (new state, log-weights), got {len(out)} tensors")
    for name, t, shape in (("out[0]", out[0], tuple(state.shape)),
                           ("out[1]", out[1], tuple(state.shape[::2]))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32 or t.device != state.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {state.device}")


def _check(params, state, y, draws, draws_name, draws_dtype, carry_logw):
    if state.dim() != 3:
        raise ValueError(f"state must be (M, S, N), got {tuple(state.shape)}")
    m = state.shape[0]
    if params.dim() != 2 or params.shape[0] != m:
        raise ValueError(f"params must be (M, P) = ({m}, P), got {tuple(params.shape)}")
    if y.numel() != 1:
        raise ValueError(f"y must hold one observation, got shape {tuple(y.shape)}")
    checks = [("params", params, torch.float32), ("state", state, torch.float32),
              ("y", y, torch.float32), (draws_name, draws, draws_dtype)]
    if carry_logw is not None:
        if tuple(carry_logw.shape) != tuple(state.shape[::2]):
            raise ValueError(f"carry_logw must be (M, N), got {tuple(carry_logw.shape)}")
        checks.append(("carry_logw", carry_logw, torch.float32))
    for name, t, dtype in checks:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != state.device:
            raise ValueError(f"{name} is on {t.device}, state on {state.device}")
        if name != "state" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # an axis of length 1 is never stepped along, whatever its stride (a
    # one-row or one-plane view: the per-θ filters' clouds)
    _, s, n = state.shape
    if (n > 1 and state.stride(2) != 1) or (s > 1 and state.stride(1) != n):
        raise ValueError("state's planes must be contiguous rows of N")


# Launch shapes, from sweeps on the H100 at 512×1024 and 512×8192: a
# program takes BLOCK particles at a time with WARPS warps. A normalized row
# of up to BLOCK particles is one program that holds it in registers; a
# longer one is one program that loops over it and rewrites log_norm in
# blocks of up to BLOCK2. Without the normalize a row is split over programs
# of BLOCK. The loop's loads run STAGES blocks ahead (Triton's pipelining).
BLOCK, BLOCK2, WARPS, STAGES = 1024, 8192, 8, 2
# A normalized row of more than SPLIT_ABOVE particles takes the split route:
# programs of SPLIT_TILE particles, grid (M·⌈N / SPLIT_TILE⌉,), launched in
# groups of rows whose raw log-weights fit GROUP_BYTES of the 50 MB L2, so
# that a row's last program rewrites them from L2. From sweeps on the H100
# (PERF.md §6) at 1 to 512 rows of 12,288 to 65,536: at 64 rows of
# 65,536 the split route takes half the loop route's time, at 512 rows of
# 32,768 and more about as long (LG less), and at 512 rows of 16,384 and
# fewer 8–10% longer, hence the threshold.
SPLIT_ABOVE, SPLIT_TILE, GROUP_BYTES = 16384, 4096, 16 << 20


def _launch_config(n: int, normalize: bool):
    """(BLOCK, BLOCK2, programs per row, num_warps, LOOP) for rows of n: a
    function of n alone, so a row's bits never depend on how many rows
    share the launch. More than one program a normalized row is the split
    route."""
    pow2 = max(1 << max(n - 1, 0).bit_length(), 128)  # a power of two ≥ n
    block = min(pow2, BLOCK)
    loop = normalize and pow2 > BLOCK
    if not normalize:
        tiles = -(-n // block)
    else:
        tiles = -(-n // SPLIT_TILE) if n > SPLIT_ABOVE else 1
    return block, min(pow2, BLOCK2), tiles, min(WARPS, block // 128), loop


def fused_elementwise_step(update: ElementwiseUpdate, params, state, y,
                           seed=None, normals=None, row_offset: int = 0,
                           carry_logw=None, normalize: bool = True,
                           particle_offset: int = 0, out=None):
    """One fused propagate + reweight (+ normalize) step for all (M, N)
    particles.

    Args:
      update: the model's :class:`ElementwiseUpdate`.
      params: (M, P) f32 per-θ parameters.
      state: (M, S, N) f32 state planes, contiguous within a row; rows may
        be strided (a view of a wider cloud is not copied), and an axis of
        length 1 may have any stride.
      y: the observation, a one-element f32 tensor on the state's device.
      seed: (1,) int64 Philox seed on the device (CUDA tensors).
      normals: (n_normals, M, N) f32 draws (CPU tensors: the plain version).
      row_offset: global index of row 0 (θ-sharding), for the draws.
      particle_offset: global index of particle 0 (particle-axis
        sharding: the rank's slice of every row), for the draws.
      carry_logw: optional (M, N) f32 carried log-weights, added to the
        observation log-weights before the normalize; the returned lse is
        then log Σ exp(carry + logw). Requires ``normalize``.
      normalize: False skips the normalize and returns the raw log-weights.
      out: optional (new state (M, S, N), log_norm or logw (M, N)),
        contiguous f32, written in place with the bits the call would
        return (the buffers a CUDA graph reads and writes).

    Returns (new state (M, S, N), log_norm (M, N), lse (M, 1), ess (M, 1)),
    or (new state, logw (M, N)) with ``normalize=False``. CUDA launches are
    counted per instance (the update's name, with ``_carry`` appended on the
    carry route, ``_split`` on the split route and ``_raw`` on the route
    without normalize) in ``fused_elementwise_step.instance_launches``.
    """
    if carry_logw is not None and not normalize:
        raise ValueError("carry_logw requires normalize=True")
    check_out(out, state)
    if state.device.type == "cpu":
        if normals is None:
            raise ValueError("on the CPU the plain version takes injected normals")
        _check(params, state, y, normals, "normals", torch.float32, carry_logw)
        if tuple(normals.shape) != (update.n_normals,) + tuple(state.shape[::2]):
            raise ValueError(f"normals must be (n_normals, M, N), got {tuple(normals.shape)}")
        return fused_elementwise_step_plain(update, params, state, y, normals,
                                            carry_logw, normalize, out)
    if state.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.device}")
    if seed is None:
        raise ValueError("the kernel draws its own normals: pass seed=")
    _check(params, state, y, seed, "seed", torch.int64, carry_logw)
    if particle_offset < 0:
        raise ValueError(f"particle_offset must be ≥ 0, got {particle_offset}")
    m, s, n = state.shape
    k = _triton_kernels()
    if out is None:
        new = torch.empty_like(state)
        log_norm = torch.empty((m, n), device=state.device, dtype=torch.float32)
    else:
        new, log_norm = out
    # lse and ess: (M, 1) outputs of the normalize; unused pointers without it
    lse = torch.empty((m, 1), device=state.device, dtype=torch.float32) if normalize else log_norm
    ess = torch.empty((m, 1), device=state.device, dtype=torch.float32) if normalize else log_norm
    block, block2, tiles, num_warps, loop = _launch_config(n, normalize)
    split = normalize and tiles > 1
    if split:
        # each tile's (max, Σe, Σe²), and each row's ticket counter from 0
        partials = torch.empty((m, 3, tiles), device=state.device, dtype=torch.float32)
        tickets = torch.zeros((m,), device=state.device, dtype=torch.int32)
        grid, group_rows = (m * tiles,), max(1, GROUP_BYTES // (4 * n))
    else:
        partials = tickets = log_norm  # unused
        grid, group_rows = (m, tiles), 1
    has_carry = carry_logw is not None
    with torch.cuda.device(state.device):
        k.step[grid](params, state, new, carry_logw if has_carry else log_norm, log_norm, lse,
                     ess, y, seed, partials, tickets, row_offset, particle_offset, n,
                     state.stride(0), group_rows,
                     P=params.shape[1], S=s, UPDATE=_update_fn(update.triton),
                     N_NORMALS=update.n_normals, HAS_CARRY=has_carry,
                     NORMALIZE=normalize, LOOP=loop, BLOCK=block, BLOCK2=block2,
                     STAGES=STAGES, SPLIT=split, TILE=SPLIT_TILE,
                     TILES_P2=1 << max(tiles - 1, 0).bit_length(), num_warps=num_warps)
    fused_elementwise_step.instance_launches[
        update.triton + ("_carry" if has_carry else "") + ("_split" if split else "")
        + ("" if normalize else "_raw")] += 1
    if not normalize:
        return new, log_norm
    return new, log_norm, lse, ess


_build.launch_counter(fused_elementwise_step, "instance_launches", collections.Counter())
