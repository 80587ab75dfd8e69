"""UC-SV filtering animation — the port's counterpart of
``examples/ucsv_animation.py`` (the parity artifact for the reference's
``visuals/ucsv_animation.gif``: the Stock–Watson trend and stochastic
volatilities filtered online over the PCE inflation series).

Runs a bootstrap filter (``filter_sequence``: K1 + K2-UC-SV at one row on
the card) on the UC-SV model at the posterior-mean θ̂ of the flagship SMC²
run (the JAX program's ``THETA_HAT``), collecting per step the weighted
quantile bands of the trend and of both volatilities σε,t = exp(½ log σε,t)
and ση,t = exp(½ log ση,t), and writes the frames' series to an ``.npz``
beside the GIF path; then, unless ``--no-figures`` (matplotlib is imported
only to draw), renders the GIF. The vendored series is a synthetic
stand-in for FRED PCECTPI, stamped on the figure.

  python -m sequential_monte_carlo_tpu_torch.examples.ucsv_animation \\
      [--n 4096] [--out PATH] [--no-figures] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

import sequential_monte_carlo_tpu_torch as smc
from sequential_monte_carlo_tpu_torch.analysis import weighted_quantile
from sequential_monte_carlo_tpu_torch.examples.inflation import ANNOT, load_pce

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "examples" / "out" / "torch" / "ucsv_animation.gif"
PS = (0.16, 0.5, 0.84)
# the flagship SMC² posterior mean (γ, x0, log σε0, log ση0), as in the JAX
# program (examples/ucsv_animation.py:38)
THETA_HAT = [0.4248, 1.8959, 0.3342, 0.3291]


def run_animation(n: int = 4096, out=str(OUT), figures: bool = True, device="cuda",
                  seed: int = 0, t: int | None = None, stride: int = 2, fps: int = 12) -> dict:
    """Filter the PCE series (its first ``t`` quarters, all by default) at
    θ̂ and write ``<out stem>.npz`` (and the GIF with ``figures``). Returns
    {"log_z", "y", "xq", "seq", "snq" (T, 3) each, "npz", "wall_s"} (the
    wall of the filter alone)."""
    dates, y, _ = load_pce(device)
    if t is not None:
        dates, y = dates[:t], y[:t]
    model = smc.ucsv_model(torch.tensor(THETA_HAT, device=device))
    ps = torch.tensor(PS, device=device)

    def summarize(state):
        w = torch.exp(state.log_weights)
        x = state.particles[:, 0]
        se = torch.exp(0.5 * state.particles[:, 1])  # trend vol σε
        sn = torch.exp(0.5 * state.particles[:, 2])  # obs vol ση
        return {"xq": weighted_quantile(x, w, ps), "seq": weighted_quantile(se, w, ps),
                "snq": weighted_quantile(sn, w, ps)}

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, log_z, series = smc.filter_sequence(torch.Generator(device=device).manual_seed(seed),
                                           model, n, y, summarize=summarize)
    log_z = log_z.item()
    wall = time.perf_counter() - t0
    s = series["summary"]
    res = {"log_z": log_z, "y": y.cpu().numpy(), "wall_s": wall,
           **{k: s[k].cpu().numpy() for k in ("xq", "seq", "snq")}}
    os.makedirs(os.path.dirname(out), exist_ok=True)
    res["npz"] = os.path.splitext(out)[0] + ".npz"
    np.savez(res["npz"], dates=dates, y=res["y"], xq=res["xq"], seq=res["seq"],
             snq=res["snq"], log_z=log_z)
    print(f"filtered T={len(y)} N={n}; logZ={log_z:.2f}; series in {res['npz']}", flush=True)
    if figures:
        _draw(res, dates, out, stride, fps)
    return res


def _draw(res: dict, dates, out: str, stride: int, fps: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.dates as mdates
    import matplotlib.pyplot as plt
    from matplotlib import animation

    y, xq, seq, snq = res["y"], res["xq"], res["seq"], res["snq"]
    T = len(y)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10.5, 4),
                                   gridspec_kw={"width_ratios": [2.0, 1.2]})
    fig.text(0.995, 0.005, ANNOT, ha="right", va="bottom", fontsize=7, color="0.45",
             style="italic")
    frames = list(range(1, T, stride)) + [T - 1]
    ylo, yhi = float(y.min()) - 1.0, float(y.max()) + 1.0
    vhi = float(max(seq[:, 2].max(), snq[:, 2].max())) * 1.1

    def draw(t):
        ax1.clear()
        ax2.clear()
        d = dates[: t + 1]
        ax1.plot(d, y[: t + 1], ".", color="0.4", ms=3, label="inflation")
        ax1.fill_between(d, xq[: t + 1, 0], xq[: t + 1, 2], color="tab:red", alpha=0.25,
                         label="filtered trend 68% band")
        ax1.plot(d, xq[: t + 1, 1], color="tab:red", lw=1.2)
        ax1.set_xlim(dates[0], dates[-1])
        ax1.set_ylim(ylo, yhi)
        ax2.fill_between(d, seq[: t + 1, 0], seq[: t + 1, 2], color="tab:blue", alpha=0.25)
        ax2.plot(d, seq[: t + 1, 1], color="tab:blue", lw=1.2, label="trend vol σε")
        ax2.fill_between(d, snq[: t + 1, 0], snq[: t + 1, 2], color="tab:green", alpha=0.25)
        ax2.plot(d, snq[: t + 1, 1], color="tab:green", lw=1.2, label="obs vol ση")
        ax2.set_xlim(dates[0], dates[-1])
        ax2.set_ylim(0.0, vhi)
        for ax in (ax1, ax2):
            ax.xaxis.set_major_locator(mdates.AutoDateLocator())
            ax.xaxis.set_major_formatter(mdates.DateFormatter("%Y"))
            ax.legend(loc="upper right", fontsize=8)
        ax1.set_title(f"UC-SV bootstrap filter, t={t}")
        ax2.set_title("filtered stochastic volatilities")

    anim = animation.FuncAnimation(fig, draw, frames=frames, interval=80)
    anim.save(out, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    print(f"wrote {out}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--stride", type=int, default=2, help="animate every k-th quarter")
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--no-figures", action="store_true",
                   help="write the series (.npz) only (no matplotlib needed)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run_animation(args.n, args.out, not args.no_figures, args.device, stride=args.stride,
                  fps=args.fps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
