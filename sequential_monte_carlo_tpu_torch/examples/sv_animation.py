"""Stochastic-volatility filtering animation — the port's counterpart of
``examples/sv_animation.py`` (the parity artifact for the reference's
``visuals/stochastic_volatility_animation.gif``).

Simulates the SV model (x = log-volatility AR(1), y ~ N(0, exp(x/2))), runs
a bootstrap filter (``filter_sequence``: K1 + K2-SV at one row on the card)
collecting per step the filtering distribution's weighted quantiles and a
weighted histogram of x_t, and writes the frames' series to an ``.npz``
beside the GIF path; then, unless ``--no-figures`` (matplotlib is imported
only to draw), renders the GIF: returns and the filtered ±1σ log-volatility
band growing through time, and the current filtering histogram.

  python -m sequential_monte_carlo_tpu_torch.examples.sv_animation \\
      [--t 150] [--n 4096] [--out PATH] [--no-figures] [--device cpu]
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

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "examples" / "out" / "torch" / "stochastic_volatility_animation.gif"
PS = (0.16, 0.5, 0.84)
SV_THETA = (-1.0, 0.95, 0.3)  # (mu, phi, sigma)
LO_EDGE, HI_EDGE = -4.0, 2.0


def run_animation(t: int = 150, n: int = 4096, bins: int = 40, out=str(OUT),
                  figures: bool = True, device="cuda", seed: int = 0, fps: int = 12) -> dict:
    """Simulate, filter and write ``<out stem>.npz`` (and the GIF with
    ``figures``). Returns {"log_z", "y", "x_true", "q" (T, 3), "hist"
    (T, bins), "npz", "wall_s"} (the wall of the filter alone)."""
    model = smc.stochastic_volatility(*SV_THETA, device=device)
    x_true, y = smc.simulate(torch.Generator(device=device).manual_seed(7), model, t)
    edges = torch.linspace(LO_EDGE, HI_EDGE, bins + 1, device=device)
    ps = torch.tensor(PS, device=device)

    def summarize(state):
        x = state.particles[:, 0]
        w = torch.exp(state.log_weights)
        # the weighted histogram of the filtering distribution over x_t
        idx = torch.clamp(torch.searchsorted(edges, x, right=True) - 1, 0, bins - 1)
        hist = torch.zeros(bins, device=device).index_add_(0, idx, w)
        return {"q": weighted_quantile(x, w, ps), "hist": hist}

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, log_z, series = smc.filter_sequence(torch.Generator(device=device).manual_seed(seed),
                                           model, n, y, summarize=summarize)
    log_z = log_z.item()  # a host read: the filter's work is done
    wall = time.perf_counter() - t0
    res = {"log_z": log_z, "y": y.cpu().numpy(), "x_true": x_true[:, 0].cpu().numpy(),
           "q": series["summary"]["q"].cpu().numpy(),
           "hist": series["summary"]["hist"].cpu().numpy(), "wall_s": wall}
    os.makedirs(os.path.dirname(out), exist_ok=True)
    res["npz"] = os.path.splitext(out)[0] + ".npz"
    np.savez(res["npz"], y=res["y"], x_true=res["x_true"], q=res["q"], hist=res["hist"],
             edges=edges.cpu().numpy(), log_z=log_z)
    print(f"filtered T={t} N={n}; logZ={log_z:.2f}; series in {res['npz']}", flush=True)
    if figures:
        _draw(res, edges.cpu().numpy(), out, fps)
    return res


def _draw(res: dict, edges: np.ndarray, out: str, fps: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    y, x, q, hists = res["y"], res["x_true"], res["q"], res["hist"]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4), gridspec_kw={"width_ratios": [2.2, 1]})
    centers = 0.5 * (edges[:-1] + edges[1:])
    tt = np.arange(len(y))

    def draw(t):
        ax1.clear()
        ax2.clear()
        ax1.plot(tt[: t + 1], y[: t + 1], ".", color="0.4", ms=3, label="returns y")
        ax1.fill_between(tt[: t + 1], q[: t + 1, 0], q[: t + 1, 2], color="tab:red",
                         alpha=0.25, label="filtered log-vol 68% band")
        ax1.plot(tt[: t + 1], q[: t + 1, 1], color="tab:red", lw=1.2)
        ax1.plot(tt[: t + 1], x[: t + 1], color="k", lw=0.8, ls="--", label="true log-vol")
        ax1.set_xlim(0, len(y))
        ax1.set_ylim(min(LO_EDGE, float(y.min()) - 0.5), max(HI_EDGE, float(y.max()) + 0.5))
        ax1.legend(loc="upper right", fontsize=8)
        ax1.set_title(f"SV bootstrap filter, t={t}")
        ax2.bar(centers, hists[t], width=centers[1] - centers[0], color="tab:red", alpha=0.6)
        ax2.axvline(x[t], color="k", ls="--", lw=0.8)
        ax2.set_title("p(x_t | y_1:t)")
        ax2.set_xlim(LO_EDGE, HI_EDGE)

    anim = animation.FuncAnimation(fig, draw, frames=len(y), interval=80)
    anim.save(out, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    print(f"wrote {out}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--t", type=int, default=150)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--bins", type=int, default=40)
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--no-figures", action="store_true",
                   help="write the series (.npz) only (no matplotlib needed)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run_animation(args.t, args.n, args.bins, args.out, not args.no_figures, args.device,
                  fps=args.fps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
