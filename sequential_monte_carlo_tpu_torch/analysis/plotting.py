"""Matplotlib plotting (L4) — counterpart of
``sequential_monte_carlo_tpu/analysis/plotting.py``, the same figures:
grouped θ-posterior histograms (plotting_utils.jl:5-54), filtered-state band
plots (:57-92, examples/inflation_example.jl:100-145), the quantile-fan
state-trajectory plot with a YlGnBu palette (:161-219) and the log variance
ratio (inflation_example.jl:404-423).

matplotlib is imported inside the drawing functions, not with the module, so
that the package imports on a machine without it (the card's); a drawing
call there raises an ImportError that names it. Tensors are drawn from the
host (a card tensor is copied back).
"""
from __future__ import annotations

import math

import numpy as np


def _pyplot():
    """matplotlib and pyplot on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return matplotlib, plt


def _np(x) -> np.ndarray:
    """An array, list or tensor (on any device) as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _annotate(fig, annotation):
    """Stamp a provenance caveat (e.g. "synthetic stand-in series") onto
    the figure itself, so that an exported artifact can't be mistaken for a
    real-data result."""
    if annotation:
        fig.text(0.995, 0.005, annotation, ha="right", va="bottom",
                 fontsize=7, color="0.45", style="italic")


def _date_axis(ax) -> None:
    import matplotlib.dates as mdates

    ax.xaxis.set_major_locator(mdates.AutoDateLocator())
    ax.xaxis.set_major_formatter(mdates.DateFormatter("%Y"))


def _finish(fig, plt, path, annotation=None):
    fig.tight_layout()
    _annotate(fig, annotation)
    if path:
        fig.savefig(path)
        plt.close(fig)
    return fig


def plot_histograms(histograms, var_names=None, path=None, annotation=None):
    """Grouped 2-wide histogram panel ≡ plot_histograms (plotting_utils.jl:39-54).

    ``histograms`` is the output of :func:`..analysis.posterior_histograms`.
    """
    _, plt = _pyplot()
    k = len(histograms)
    rows = math.ceil(k / 2)
    fig, axes = plt.subplots(rows, 2, figsize=(8, 2.5 * rows), squeeze=False)
    for i, (counts, edges) in enumerate(histograms):
        ax = axes[i // 2][i % 2]
        ax.stairs(_np(counts), _np(edges), fill=True, alpha=0.7)
        ax.set_yticks([])
        if var_names is not None:
            ax.set_title(var_names[i])
    for j in range(k, rows * 2):
        axes[j // 2][j % 2].axis("off")
    return _finish(fig, plt, path, annotation)


def plot_filtered_band(y, lower, median, upper, label="filtered trend", path=None,
                       dates=None, title=None, annotation=None):
    """Observed data + filtered quantile band ≡ the inflation example's
    trend plots (examples/inflation_example.jl:100-122). ``dates`` (e.g. an
    np.datetime64 array) puts the x-axis on calendar time with year ticks
    ≡ the reference's date_coordinates_in="x" axes (plotting_utils.jl:57-92)."""
    _, plt = _pyplot()
    y = _np(y)
    t = np.arange(len(y)) if dates is None else np.asarray(dates)
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.scatter(t, y, s=8, color="black", label="observed data")
    ax.fill_between(t, _np(lower), _np(upper), color="grey", alpha=0.35)
    ax.plot(t, _np(median), color="red", label=label)
    ax.legend()
    if dates is not None:
        _date_axis(ax)
    if title:
        ax.set_title(title)
    return _finish(fig, plt, path, annotation)


def plot_state_trajectory(xs, qs, path=None):
    """Quantile-fan plot ≡ plot_state_trajectory (plotting_utils.jl:161-219).

    ``xs``: (T,) state path; ``qs``: (n_probs, T) quantile curves
    (symmetric probability levels, lowest first)."""
    matplotlib, plt = _pyplot()
    xs, qs = _np(xs), _np(qs)
    n_probs, T = qs.shape
    n_fills = n_probs // 2
    cols = matplotlib.colormaps["YlGnBu"](np.linspace(0.3, 0.9, max(n_fills, 3)))
    fig, ax = plt.subplots(figsize=(9, 4.5))
    t = np.arange(T)
    for i in range(n_fills):
        c = cols[n_fills - 1 - i]
        ax.fill_between(t, qs[i], qs[n_probs - i - 1], color=c, alpha=0.6, linewidth=0)
        ax.plot(t, qs[i], color=c, linewidth=0.8)
        ax.plot(t, qs[n_probs - i - 1], color=c, linewidth=0.8)
    ax.plot(t, xs, color="black", linewidth=1.2)
    ax.set_xlim(0, T - 1)
    return _finish(fig, plt, path)


def plot_variance_ratio(log_ratio_series, labels=None, path=None, dates=None,
                        annotation=None):
    """log var(P(x,θ|y)) − log var(P(x|y,θ)) over time
    ≡ examples/inflation_example.jl:404-423."""
    _, plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 3.5))
    series = np.atleast_2d(np.stack([_np(s) for s in log_ratio_series])
                           if isinstance(log_ratio_series, (list, tuple))
                           else _np(log_ratio_series))
    for i, s in enumerate(series):
        t = np.arange(len(s)) if dates is None else np.asarray(dates)[:len(s)]
        ax.plot(t, s, label=None if labels is None else labels[i])
    if dates is not None:
        _date_axis(ax)
    ax.set_title("ratio of var(P(x,θ|y)) to var(P(x|y,θ))")
    if labels is not None:
        ax.legend()
    return _finish(fig, plt, path, annotation)
