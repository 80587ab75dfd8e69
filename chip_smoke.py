#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sequential_monte_carlo_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. device — a CUDA device is required (no CPU fallback); prints the card's
     name and power limit as nvidia-smi reports them;
  2. build  — compiles the CUDA kernels from the package's csrc/ with nvcc;
  3. K1     — the resample + gather kernel against its plain version at
     512×1024 and 512×8192 (C=3) under flat, skewed and point-mass weights;
  4. K2     — the fused propagate + reweight + normalize kernel against its
     plain version at the same shapes, and its normals' statistics;
  5. slice  — online SMC² on UC-SV at the benchmark's configuration
     (M=512, N=1024, T=241, chain=5), whose launch counts show that every
     inner filter step ran both kernels, and whose posterior mean is held
     against the JAX package's; then the 512×8192 run, timed once.
The line before the last carries the card's name and power limit; the
last line is ``{"ok": true, "device": {...}}``. Nothing here imports JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0  # the slice's torch.Generator seed
T, CHAIN = 241, 5

# Posterior mean of θ = (γ, x0, log σε0, log ση0) from the JAX package at
# this configuration (M=512, N=1024, T=241, chain=5, same prior and series),
# on the CPU, over seeds jax.random.key(0..7): the mean of the 8 runs' means
# and their standard deviation.
JAX_MEAN = [0.189923, 3.431845, 0.226644, 0.28478]
JAX_SD = [0.009306, 0.206255, 0.033334, 0.043362]
JAX_SEEDS = 8
# The port's mean from one run differs from JAX_MEAN by a draw of the seed
# spread plus the error of an 8-run mean: sd·√(1 + 1/8). Allow 5 of those.
TOL_Z = 5.0

PRIOR_SPEC = [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
              ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)]  # bench.py:105-112


def say(phase: str, **fields) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def series(torch, device):
    """bench.py's synthetic inflation-like series (bench.py:178-182)."""
    rng = np.random.default_rng(1998)
    y = 3.0 + np.cumsum(rng.normal(0, 0.3, T)) + rng.normal(0, 0.5, T)
    return torch.tensor(y, dtype=torch.float32, device=device)


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time per call over ``iters`` calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_k1(torch, shapes, gen):
    from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
        resample_gather,
        resample_gather_plain,
    )

    out = {"max_abs_err": 0.0}
    for m, n in shapes:
        xs = torch.randn((m, 3, n), generator=gen, device="cuda")
        u0 = torch.rand((m, 1), generator=gen, device="cuda")
        point = torch.zeros((m, n), device="cuda")
        point[torch.arange(m, device="cuda"), torch.randint(0, n, (m,), generator=gen, device="cuda")] = 1.0
        profiles = {
            "flat": torch.ones((m, n), device="cuda"),
            "skewed": torch.softmax(2.0 * torch.randn((m, n), generator=gen, device="cuda"), -1),
            "point": point,
        }
        for name, w in profiles.items():
            got, anc = resample_gather(u0, w, xs, return_ancestors=True)
            ref, anc_ref = resample_gather_plain(u0, w, xs)
            torch.cuda.synchronize()
            agree = anc == anc_ref
            frac = 1.0 - agree.float().mean().item()
            if frac > 1e-3:
                raise AssertionError(f"K1 {m}x{n} {name}: ancestors differ on {frac:.2e} of slots")
            idx = anc.long()[:, None, :].expand(xs.shape)
            if not torch.equal(got, torch.gather(xs, 2, idx)):
                raise AssertionError(f"K1 {m}x{n} {name}: output != xs gathered by its ancestors")
            counts = torch.zeros((m, n), device="cuda").scatter_add_(1, anc.long(), torch.ones_like(w))
            if not (torch.all(counts.sum(1) == n) and torch.all(anc[:, 1:] >= anc[:, :-1])
                    and torch.all((anc >= 0) & (anc < n))):
                raise AssertionError(f"K1 {m}x{n} {name}: ancestors are not a systematic draw")
            err = (got - ref).abs()[agree[:, None, :].expand(xs.shape)].max().item()
            out["max_abs_err"] = max(out["max_abs_err"], err)
            say("K1", shape=f"{m}x{n}", weights=name, anc_mismatch=f"{frac:.2e}",
                max_abs_err_on_agreeing=err)
        w = profiles["skewed"]
        out[f"{m}x{n}"] = (time_ms(torch, lambda: resample_gather(u0, w, xs)),
                           time_ms(torch, lambda: resample_gather_plain(u0, w, xs)))
        say("K1", shape=f"{m}x{n}", ms=out[f"{m}x{n}"][0], plain_ms=out[f"{m}x{n}"][1])
    return out


def check_k2(torch, shapes, gen):
    from sequential_monte_carlo_tpu_torch.kernels.propagate import (
        fused_elementwise_step,
        fused_elementwise_step_plain,
    )
    from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE, ucsv_update
    from sequential_monte_carlo_tpu_torch.ops.weights import log_normalize

    out = {"max_abs_err": 0.0}
    y = torch.tensor(1.3, device="cuda")
    for m, n in shapes:
        state = torch.randn((m, 3, n), generator=gen, device="cuda")
        state[:, 1:] *= 0.5
        seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
        zeros = torch.zeros((m, 2), device="cuda")
        new0, *_ = fused_elementwise_step(UCSV_UPDATE, zeros, state, y, seed=seed)
        if not torch.equal(new0[:, 1:], state[:, 1:]):
            raise AssertionError(f"K2 {m}x{n}: with γ=0 the log-vol planes moved")

        gamma = (0.3, 0.2)
        params = torch.tensor(gamma, device="cuda").expand(m, 2).contiguous()
        new, log_norm, lse, ess = fused_elementwise_step(UCSV_UPDATE, params, state, y, seed=seed)
        # logw from the plain UC-SV density at the returned state, normalized
        # by the plain log_normalize
        zcol = torch.zeros((m, 1), device="cuda")
        planes = tuple(new[:, s] for s in range(3))
        _, logw_ref = ucsv_update((zcol, zcol), y, planes, (0.0, 0.0, 0.0))
        log_mean_ref, log_norm_ref, ess_ref = log_normalize(logw_ref)
        tol = dict(rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(log_norm + lse, logw_ref, **tol)
        torch.testing.assert_close(log_norm, log_norm_ref, **tol)
        torch.testing.assert_close(lse[:, 0], log_mean_ref + math.log(n), **tol)
        torch.testing.assert_close(ess[:, 0], ess_ref, **tol)
        # the normals the kernel drew, recovered from the state deltas, into
        # the plain version: it must give the kernel's outputs
        z = torch.stack([(new[:, 0] - state[:, 0]) / torch.exp(0.5 * state[:, 1]),
                         (new[:, 1] - state[:, 1]) / gamma[0],
                         (new[:, 2] - state[:, 2]) / gamma[1]])
        ref = fused_elementwise_step_plain(UCSV_UPDATE, params, state, y, z)
        for got, want in zip((new, log_norm, lse, ess), ref):
            torch.testing.assert_close(got, want, **tol)
        err = max((new - ref[0]).abs().max().item(), (log_norm - ref[1]).abs().max().item())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        flat = z.reshape(3, -1).double()
        mean = flat.mean(1).abs().max().item()
        var = (flat.var(1) - 1.0).abs().max().item()
        corr = torch.corrcoef(flat)
        rho = (corr - torch.diag(torch.diag(corr))).abs().max().item()
        if not (mean < 5e-3 and var < 1e-2 and rho < 5e-3):
            raise AssertionError(f"K2 {m}x{n}: normals off: |mean| {mean}, |var-1| {var}, |corr| {rho}")
        say("K2", shape=f"{m}x{n}", max_abs_err=err, normals_abs_mean=mean,
            normals_abs_var_dev=var, normals_abs_corr=rho)

        def plain():
            zz = torch.randn((3, m, n), generator=gen, device="cuda")
            return fused_elementwise_step_plain(UCSV_UPDATE, params, state, y, zz)

        out[f"{m}x{n}"] = (
            time_ms(torch, lambda: fused_elementwise_step(UCSV_UPDATE, params, state, y, seed=seed)),
            time_ms(torch, plain),
        )
        say("K2", shape=f"{m}x{n}", ms=out[f"{m}x{n}"][0], plain_ms=out[f"{m}x{n}"][1])
    return out


def run_slice(torch, n: int, seed: int):
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    prior = prior_from_spec(PRIOR_SPEC, device="cuda")
    cfg = smc.SMCConfig(n_particles=n, n_theta=512, chain=CHAIN, ess_threshold=0.5,
                        inner=smc.PFConfig("systematic", 1.0))
    sampler = smc.SMC2(smc.ucsv_model, prior, cfg)
    y = series(torch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, infos = sampler.run(gen, y)
    torch.cuda.synchronize()
    return state, infos, time.perf_counter() - t0


def main() -> int:
    import torch

    # -- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", name=repr(kind), count=torch.cuda.device_count(), nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build
    from sequential_monte_carlo_tpu_torch.kernels import _build
    from sequential_monte_carlo_tpu_torch.kernels.propagate import fused_elementwise_step
    from sequential_monte_carlo_tpu_torch.kernels.resample_walk import resample_gather

    t0 = time.perf_counter()
    _build.library()
    say("build", seconds=round(time.perf_counter() - t0, 3), library=_build.library_path().name)

    # -- 3, 4. kernels against their plain versions
    shapes = [(512, 1024), (512, 8192)]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1 = check_k1(torch, shapes, gen)
    k2 = check_k2(torch, shapes, gen)

    # -- 5. the slice, through the public entry points
    resample_gather.launches = 0
    fused_elementwise_step.launches = 0
    state, infos, wall = run_slice(torch, 1024, SEED)
    launches = (resample_gather.launches, fused_elementwise_step.launches)
    rejuv_t = (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist()
    expected = (T - 1) + sum(CHAIN * (t - 1) for t in rejuv_t)
    ess = state.ess.item()
    if not math.isfinite(ess):
        raise AssertionError(f"slice: θ-ESS is {ess}")
    if launches != (expected, expected):
        raise AssertionError(f"slice: launches {launches}, expected {expected} each")
    import sequential_monte_carlo_tpu_torch as smc

    mean = smc.expected_parameters(state).cpu().numpy()
    tol = TOL_Z * np.asarray(JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    if not np.all(np.abs(mean - np.asarray(JAX_MEAN)) <= tol):
        raise AssertionError(f"slice: posterior mean {mean} vs JAX {JAX_MEAN} beyond {tol}")
    say("slice", shape="512x1024", T=T, chain=CHAIN, wall_s=round(wall, 4),
        rejuvenations=len(rejuv_t), rejuv_t=rejuv_t, launches=launches[0],
        ess=round(ess, 3), posterior_mean=np.round(mean, 5).tolist(),
        jax_mean=JAX_MEAN, tolerance=np.round(tol, 5).tolist())
    _, _, wall2 = run_slice(torch, 1024, SEED + 1)
    say("slice", shape="512x1024", run="second (warm)", wall_s=round(wall2, 4))
    fstate, finfos, fwall = run_slice(torch, 8192, SEED)
    fess = fstate.ess.item()
    if not math.isfinite(fess):
        raise AssertionError(f"flagship: θ-ESS is {fess}")
    say("slice", shape="512x8192", wall_s=round(fwall, 4),
        rejuvenations=int(finfos.rejuvenated.sum()), ess=round(fess, 3),
        posterior_mean=np.round(smc.expected_parameters(fstate).cpu().numpy(), 5).tolist())

    kernels = [
        {"name": "resample_count", "route": "cuda",
         "source": "sequential_monte_carlo_tpu_torch/csrc/resample_count.cu",
         "replaces": "sequential_monte_carlo_tpu/kernels/resample_walk.py:258",
         "launches": launches[0], "max_abs_err": k1["max_abs_err"],
         "ms": k1["512x1024"][0], "plain_ms": k1["512x1024"][1],
         "ms_512x8192": k1["512x8192"][0], "plain_ms_512x8192": k1["512x8192"][1]},
        {"name": "fused_propagate_ucsv", "route": "triton",
         "source": "sequential_monte_carlo_tpu_torch/kernels/propagate.py",
         "replaces": "sequential_monte_carlo_tpu/kernels/propagate_pallas.py:48",
         "launches": launches[1], "max_abs_err": k2["max_abs_err"],
         "ms": k2["512x1024"][0], "plain_ms": k2["512x1024"][1],
         "ms_512x8192": k2["512x8192"][0], "plain_ms_512x8192": k2["512x8192"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
