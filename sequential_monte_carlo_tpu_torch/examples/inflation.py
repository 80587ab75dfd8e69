"""End-to-end inflation example — UC and UC-SV models on PCE inflation; the
port's counterpart of ``examples/inflation_example.py`` (the reference's
acceptance pipeline, inflation_example.jl).

Quarterly PCE inflation 1960–2020 (T=241): online SMC² on (1) the local-level
UC model (``--full``: N=1024, M=512, chain=3) and (2) the Stock–Watson UC-SV
model (N=8192, M=512, chain=5), both with the θ-ESS threshold 0.5,
collecting per-t ω-weighted trend and cycle quantiles and variances
(``run_online``); then a bootstrap filter at the posterior mean θ̂ with
per-t weighted quantiles and the FFBS marginal smoother at the full N
(``run_pf_at_theta_hat``); the θ-posterior-mixture smoothed trend, 8 θ
draws × 64 backward-sampled paths (``run_posterior_smoothing``); and the
log variance ratio var(P(x,θ|y)) / var(P(x|y,θ)).

The series is the repo's ``examples/data/pce_inflation.csv``, a synthetic
stand-in for FRED ``PCECTPI`` with the same span and shape (see the JAX
example), read by the native CSV loader (``utils/dataio.py``) where it
builds, else by Python; the output says which. Every figure is written with
the series it plots beside it as an ``.npz`` of the same name; with
``--no-figures`` (where matplotlib is missing) only the ``.npz`` files.

Run (on the card by default; ``--device cpu`` runs it on the CPU)::

  python -m sequential_monte_carlo_tpu_torch.examples.inflation           # quick sizes
  python -m sequential_monte_carlo_tpu_torch.examples.inflation --full    # reference sizes
"""
from __future__ import annotations

import argparse
import csv
import os
import time
from pathlib import Path

import numpy as np
import torch

import sequential_monte_carlo_tpu_torch as smc
from sequential_monte_carlo_tpu_torch.analysis import (
    plotting,
    posterior_histograms,
    state_quantiles,
    state_variance,
    weighted_quantile,
)
from sequential_monte_carlo_tpu_torch.utils.dataio import native_loader_available, read_csv_column

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "examples" / "data" / "pce_inflation.csv"
PS = (0.25, 0.5, 0.75)
# stamped on every figure: the vendored series is NOT the FRED PCECTPI data
ANNOT = "synthetic stand-in series — not FRED PCECTPI"
# (N, M, chain) per model
FULL_SIZES = {"uc": (1024, 512, 3), "ucsv": (8192, 512, 5)}
QUICK_SIZES = {"uc": (256, 128, 3), "ucsv": (512, 128, 3)}
ESS_THRESHOLD = 0.5


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _emit(outdir, stem: str, figures: bool, plot, **series) -> None:
    """Write ``series`` to ``<stem>.npz`` and, with ``figures``, the figure
    ``plot(path=...)`` draws to ``<stem>.png``."""
    np.savez(os.path.join(outdir, f"{stem}.npz"), **{k: _np(v) for k, v in series.items()})
    if figures:
        plot(path=os.path.join(outdir, f"{stem}.png"))


def load_pce(device="cuda"):
    """(dates (T,) datetime64[D], y (T,) f32 tensor on ``device``, the loader
    that read it: "native" or "python")."""
    values = read_csv_column(str(DATA), 1)
    with open(DATA, newline="") as f:
        dates = np.array([row["date"] for row in csv.DictReader(f)], dtype="datetime64[D]")
    loader = "native" if native_loader_available() else "python"
    return dates, torch.tensor(values, dtype=torch.float32, device=device), loader


def _f(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def uc_prior(device="cuda"):
    """≡ inflation_example.jl:33-37: [Normal(3, 2), Uniform(0, 4), Uniform(0, 4)]
    over θ = (x0, σε, ση)."""
    return smc.product_distribution([
        smc.Normal(_f(3.0, device), _f(2.0, device)),
        smc.Uniform(_f(0.0, device), _f(4.0, device)),
        smc.Uniform(_f(0.0, device), _f(4.0, device)),
    ])


def ucsv_prior(device="cuda"):
    """≡ inflation_example.jl:235-240 over θ = (γ, x0, log σε0, log ση0)."""
    return smc.product_distribution([
        smc.Uniform(_f(0.0, device), _f(1.0, device)),
        smc.Normal(_f(3.0, device), _f(2.0, device)),
        smc.Uniform(_f(0.0, device), _f(2.0, device)),
        smc.Uniform(_f(0.0, device), _f(2.0, device)),
    ])


def online_collector(y):
    """The online run's collector over the series y: the per-t trend
    quantiles, the cycle quantiles and the trend's variance. SMC²'s replayed
    step captures it (t is a device tensor there, as JAX traces it), so y_t
    is taken on the device, not indexed from the host."""
    def collect(state):
        xq = state_quantiles(state, PS)
        # cycle quantiles without a second sort: q_p(y − x) = y − q_{1−p}(x)
        return {"xq": xq, "cq": torch.take(y, state.t - 1) - xq.flip(0),
                "var": state_variance(state)}
    return collect


def run_online(name, model_fn, prior, y, n, m, chain, outdir, dates=None, figures=True,
               seed=1998):
    """Online SMC² collecting per-t trend and cycle quantiles and variances
    ≡ the example's main loops (inflation_example.jl:64-74, 262-267), through
    ``run_segmented`` in segments of 16 steps. Returns a dict: the final
    state, θ̂, the per-t series ("xq", "cq" (T−1, 3), "var" (T−1,)), the
    step infos, the rejuvenation count and the wall-clock seconds."""
    cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=chain, ess_threshold=ESS_THRESHOLD)
    sampler = smc.SMC2(model_fn, prior, cfg)

    gen = torch.Generator(device=y.device).manual_seed(seed)
    _sync(y.device)
    t0 = time.perf_counter()
    state, (infos, series) = sampler.run_segmented(gen, y, segment_size=16,
                                                   collect_fn=online_collector(y))
    _sync(y.device)
    wall = time.perf_counter() - t0
    theta_hat = smc.expected_parameters(state)
    n_rejuv = int(infos.rejuvenated.sum())
    print(f"[{name}] SMC² {m}x{n} T={len(y)} in {wall:.1f}s; rejuvenations={n_rejuv}; "
          f"final ess={state.ess.item():.1f}; θ̂={np.round(_np(theta_hat), 4)}", flush=True)

    d1 = None if dates is None else dates[1:]
    y_np, xq, cq = _np(y), _np(series["xq"]), _np(series["cq"])
    _emit(outdir, f"pce_inflation_trend_{name}", figures,
          lambda path: plotting.plot_filtered_band(
              y_np[1:], xq[:, 0], xq[:, 1], xq[:, 2], label=f"filtered trend ({name})",
              title="quarterly PCE inflation rate", path=path, dates=d1, annotation=ANNOT),
          y=y_np[1:], lower=xq[:, 0], median=xq[:, 1], upper=xq[:, 2])
    _emit(outdir, f"pce_inflation_cycle_{name}", figures,
          lambda path: plotting.plot_filtered_band(
              y_np[1:] - xq[:, 1], cq[:, 0], cq[:, 1], cq[:, 2], label=f"filtered cycle ({name})",
              title="quarterly PCE inflation rate", path=path, dates=d1, annotation=ANNOT),
          y=y_np[1:] - xq[:, 1], lower=cq[:, 0], median=cq[:, 1], upper=cq[:, 2])
    hists = posterior_histograms(torch.Generator(device=y.device).manual_seed(7), state)
    _emit(outdir, f"theta_posterior_{name}", figures,
          lambda path: plotting.plot_histograms(
              hists, var_names=[f"θ{i}" for i in range(len(hists))], path=path,
              annotation=ANNOT),
          **{f"counts_{i}": c for i, (c, _) in enumerate(hists)},
          **{f"edges_{i}": e for i, (_, e) in enumerate(hists)})
    return {"state": state, "theta_hat": theta_hat, "xq": xq, "cq": cq,
            "var": _np(series["var"]), "infos": infos, "rejuvenations": n_rejuv, "wall_s": wall}


def run_pf_at_theta_hat(name, model, y, n, outdir, dates=None, figures=True, seed=0):
    """A bootstrap filter at θ̂ with per-t weighted quantiles ≡
    get_latent_states_* (inflation_example.jl:153-178, 326-355), then the
    FFBS marginal smoother at the full N (beyond the reference, which only
    filters). Returns a dict: log Z, the filtered "xq" (T, 3) and "var" (T,),
    the smoothed "trend" and "trend_sd" (T,), and the walls of the filter
    and the smoother."""
    def summarize(state):
        w = torch.exp(state.log_weights)
        x = state.particles[:, 0]
        return {"xq": weighted_quantile(x, w, PS),
                "var": torch.sum(w * (x - torch.sum(w * x)) ** 2)}

    _sync(y.device)
    t0 = time.perf_counter()
    _, logz, series = smc.filter_sequence(torch.Generator(device=y.device).manual_seed(seed),
                                          model, n, y, summarize=summarize)
    _sync(y.device)
    t1 = time.perf_counter()
    y_np, xq = _np(y), _np(series["summary"]["xq"])
    _emit(outdir, f"pce_inflation_trend_{name}_post", figures,
          lambda path: plotting.plot_filtered_band(
              y_np, xq[:, 0], xq[:, 1], xq[:, 2], label=f"filtered trend ({name})",
              title="quarterly PCE inflation rate (given θ)", path=path, dates=dates,
              annotation=ANNOT),
          y=y_np, lower=xq[:, 0], median=xq[:, 1], upper=xq[:, 2])
    print(f"[{name}] PF at θ̂: logZ={logz.item():.2f}", flush=True)

    t2 = time.perf_counter()
    sm = smc.smoothed_marginals(torch.Generator(device=y.device).manual_seed(seed + 1),
                                model, n, y)
    trend = smc.smoothed_mean(sm)[:, 0]
    w_s = torch.exp(sm.log_weights)
    sd = torch.sqrt(torch.sum(w_s * (sm.particles[..., 0] - trend[:, None]) ** 2, dim=-1))
    trend, sd = _np(trend), _np(sd)
    _sync(y.device)
    t3 = time.perf_counter()
    _emit(outdir, f"pce_inflation_trend_{name}_smoothed", figures,
          lambda path: plotting.plot_filtered_band(
              y_np, trend - sd, trend, trend + sd, label=f"smoothed trend ({name}, FFBS)",
              title="quarterly PCE inflation rate (given θ, smoothed)", path=path,
              dates=dates, annotation=ANNOT),
          y=y_np, lower=trend - sd, median=trend, upper=trend + sd)
    return {"logz": logz.item(), "xq": xq, "var": _np(series["summary"]["var"]),
            "trend": trend, "trend_sd": sd, "filter_wall_s": t1 - t0, "ffbs_wall_s": t3 - t2}


def run_posterior_smoothing(name, model_fn, state, y, n, outdir, dates=None, figures=True,
                            n_theta=8, n_paths=64, seed=11):
    """The θ-posterior-mixture smoothed trend (beyond the reference): pooled
    backward-sampled FFBS paths across θ drawn from the SMC² posterior ω —
    p(x_t | y_{1:T}) with the θ-uncertainty integrated out. Returns a dict:
    the 10/50/90% bands (T,) each and the wall."""
    _sync(y.device)
    t0 = time.perf_counter()
    paths = smc.posterior_smoothed_paths(torch.Generator(device=y.device).manual_seed(seed),
                                         model_fn, state.theta, state.log_omega, y, n=n,
                                         n_theta=n_theta, n_paths=n_paths)
    trend = _np(paths[:, :, 0])  # (T, n_theta·n_paths)
    wall = time.perf_counter() - t0
    lo, med, hi = np.percentile(trend, [10, 50, 90], axis=1)
    y_np = _np(y)
    _emit(outdir, f"pce_inflation_trend_{name}_postmix", figures,
          lambda path: plotting.plot_filtered_band(
              y_np, lo, med, hi, label=f"posterior-mixture smoothed trend ({name}, FFBS)",
              title="quarterly PCE inflation rate (θ integrated out, smoothed)", path=path,
              dates=dates, annotation=ANNOT),
          y=y_np, lower=lo, median=med, upper=hi)
    print(f"[{name}] posterior-mixture smoothing: {trend.shape[1]} paths "
          f"({n_theta} θ-draws × {n_paths})", flush=True)
    return {"lower": lo, "median": med, "upper": hi, "wall_s": wall}


def run_example(sizes=QUICK_SIZES, outdir=str(ROOT / "examples" / "out" / "torch"),
                figures=True, device="cuda", models=("uc", "ucsv")):
    """The whole example for ``models`` at ``sizes`` ({model: (N, M, chain)}).
    Returns {"loader": ..., model: {"online", "pf", "postmix"}: the dicts of
    the three parts}."""
    os.makedirs(outdir, exist_ok=True)
    dates, y, loader = load_pce(device)
    print(f"loaded {len(y)} quarters with the {loader} CSV loader", flush=True)
    model_fns = {"uc": (smc.uc_model, uc_prior), "ucsv": (smc.ucsv_model, ucsv_prior)}
    out, ratios, labels = {"loader": loader}, [], []
    eps = 1e-12
    for name in models:
        model_fn, prior = model_fns[name]
        n, m, chain = sizes[name]
        online = run_online(name, model_fn, prior(device), y, n, m, chain, outdir, dates,
                            figures)
        pf = run_pf_at_theta_hat(name, model_fn(online["theta_hat"]), y, n, outdir, dates,
                                 figures)
        postmix = run_posterior_smoothing(name, model_fn, online["state"], y, n, outdir, dates,
                                          figures)
        out[name] = {"online": online, "pf": pf, "postmix": postmix}
        # log variance ratio (inflation_example.jl:404-423)
        ratios.append(np.log(online["var"] + eps) - np.log(pf["var"][1:] + eps))
        labels.append(f"log variance ratio ({name.upper()})")
    _emit(outdir, "log_variance_ratio_inflation", figures,
          lambda path: plotting.plot_variance_ratio(ratios, labels=labels, path=path,
                                                       dates=dates[1:], annotation=ANNOT),
          **{f"ratio_{name}": r for name, r in zip(models, ratios)})
    print(f"wrote {'figures and ' if figures else ''}series to {outdir}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="reference sizes (UC 512x1024 chain 3; UC-SV 512x8192 chain 5)")
    p.add_argument("--outdir", default=str(ROOT / "examples" / "out" / "torch"))
    p.add_argument("--model", choices=["uc", "ucsv", "both"], default="both")
    p.add_argument("--no-figures", action="store_true",
                   help="write the series (.npz) only, no figures (no matplotlib needed)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run_example(FULL_SIZES if args.full else QUICK_SIZES, args.outdir, not args.no_figures,
                args.device, ("uc", "ucsv") if args.model == "both" else (args.model,))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
