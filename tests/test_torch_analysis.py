"""The port's distribution quantiles and plotting against the JAX package's.

Quantiles (``distributions/core.py``): LogNormal, Uniform, TruncatedNormal,
Product and TupleProduct at numpy-made probabilities and parameters, to
1e-5 relative. Plotting (``analysis/plotting.py``, the counterparts of
``tests/test_analysis.py``'s plotting tests): each figure drawn by both
packages from the same numpy data holds the same plotted arrays, the same
number of panels and fill bands, the dates axis and the annotation; the
port's module imports without matplotlib and a drawing call without it
raises an ImportError that names it."""
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from matplotlib.collections import PolyCollection

import sequential_monte_carlo_tpu as jsmc
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu.analysis import plotting as jplot
from sequential_monte_carlo_tpu_torch.analysis import plotting as tplot

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

RTOL = 1e-5


def _pair(rng, name):
    """(JAX distribution, port distribution) with the same numpy parameters,
    batch shape (5,)."""
    f = lambda a: (jnp.asarray(a), torch.from_numpy(a))  # noqa: E731
    if name == "lognormal":
        (jm, tm), (js, ts) = f(rng.normal(0.0, 1.0, 5).astype(np.float32)), f(
            rng.uniform(0.2, 1.5, 5).astype(np.float32))
        return jsmc.LogNormal(jm, js), tsmc.LogNormal(tm, ts)
    if name == "uniform":
        lo = rng.normal(0.0, 1.0, 5).astype(np.float32)
        hi = (lo + rng.uniform(0.5, 3.0, 5)).astype(np.float32)
        (jl, tl), (jh, th) = f(lo), f(hi)
        return jsmc.Uniform(jl, jh), tsmc.Uniform(tl, th)
    if name == "truncated_normal":
        loc = rng.normal(0.0, 1.0, 5).astype(np.float32)
        scale = rng.uniform(0.5, 2.0, 5).astype(np.float32)
        lo = (loc - rng.uniform(0.5, 2.0, 5)).astype(np.float32)
        hi = (loc + rng.uniform(0.5, 2.0, 5)).astype(np.float32)
        args = [f(a) for a in (loc, scale, lo, hi)]
        return jsmc.TruncatedNormal(*(a[0] for a in args)), tsmc.TruncatedNormal(
            *(a[1] for a in args))
    if name == "product":
        (jm, tm), (js, ts) = f(rng.normal(0.0, 1.0, 5).astype(np.float32)), f(
            rng.uniform(0.5, 2.0, 5).astype(np.float32))
        return jsmc.Product(jsmc.Normal(jm, js)), tsmc.Product(tsmc.Normal(tm, ts))
    # tuple_product: the inflation example's UC-SV prior
    comps = [("uniform", (0.0, 1.0)), ("normal", (3.0, 2.0)), ("uniform", (0.0, 2.0)),
             ("uniform", (0.0, 2.0))]
    js_, ts_ = [], []
    for kind, (a, b) in comps:
        cls = "Uniform" if kind == "uniform" else "Normal"
        js_.append(getattr(jsmc, cls)(jnp.float32(a), jnp.float32(b)))
        ts_.append(getattr(tsmc, cls)(torch.tensor(a), torch.tensor(b)))
    return jsmc.product_distribution(js_), tsmc.product_distribution(ts_)


@pytest.mark.parametrize("name", ["lognormal", "uniform", "truncated_normal", "product",
                                  "tuple_product"])
def test_quantile_matches_jax(name):
    """quantile(p) at numpy-made p in (0.001, 0.999) — a (7, 1) column
    against the (5,) batch, or (7,) for the TupleProduct — equals the JAX
    package's to 1e-5 relative; the endpoints' neighbours 1e-4 and 1 − 1e-4
    included."""
    rng = np.random.default_rng(11)
    jd, td = _pair(rng, name)
    p = np.concatenate([[1e-4, 1 - 1e-4], rng.uniform(0.001, 0.999, 5)]).astype(np.float32)
    if name != "tuple_product":
        p = p[:, None]
    got = td.quantile(torch.from_numpy(p)).numpy()
    ref = np.asarray(jd.quantile(jnp.asarray(p)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)


def test_quantile_inverts_the_truncated_normal_sampler():
    """TruncatedNormal.sample is quantile of the sampler's uniforms: the
    draws' CDF values are uniform (Kolmogorov distance under 0.02 at 20,000
    draws)."""
    d = tsmc.TruncatedNormal(torch.tensor(0.5), torch.tensor(1.5), torch.tensor(-1.0),
                             torch.tensor(2.0))
    x = d.sample(torch.Generator().manual_seed(0), (20_000,)).sort().values
    grid = d.quantile(torch.linspace(0.0, 1.0, 201)[1:-1])
    emp = torch.searchsorted(x, grid).double() / x.numel()
    assert (emp - torch.linspace(0.0, 1.0, 201)[1:-1].double()).abs().max() < 0.02


# -- plotting -----------------------------------------------------------------

def _lines(fig):
    return [(np.asarray(l.get_xdata(), dtype=float), np.asarray(l.get_ydata(), dtype=float))
            for ax in fig.axes for l in ax.lines]


def _fills(fig):
    return [[p.vertices for p in c.get_paths()] for ax in fig.axes for c in ax.collections
            if isinstance(c, PolyCollection)]


def _same_figure(f_port, f_jax):
    assert len(f_port.axes) == len(f_jax.axes)
    for (xa, ya), (xb, yb) in zip(_lines(f_port), _lines(f_jax), strict=True):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    for a, b in zip(_fills(f_port), _fills(f_jax), strict=True):
        for pa, pb in zip(a, b, strict=True):
            np.testing.assert_array_equal(pa, pb)
    assert [t.get_text() for t in f_port.texts] == [t.get_text() for t in f_jax.texts]
    for a, b in zip(f_port.axes, f_jax.axes):
        assert a.get_title() == b.get_title()
        assert type(a.xaxis.get_major_formatter()) is type(b.xaxis.get_major_formatter())
        assert (a.get_legend() is None) == (b.get_legend() is None)


def test_plot_state_trajectory_matches_jax(tmp_path):
    """The quantile fan: one band per symmetric quantile pair, their edges,
    the path on top — drawn from a tensor and from the numpy array alike."""
    rng = np.random.default_rng(0)
    xs = np.cumsum(rng.normal(size=40))
    qs = np.stack([xs - 2, xs - 1, xs + 1, xs + 2])
    out = tmp_path / "fan.png"
    fig = tplot.plot_state_trajectory(torch.from_numpy(xs), torch.from_numpy(qs), path=str(out))
    _same_figure(fig, jplot.plot_state_trajectory(xs, qs))
    assert len(_fills(fig)) == 2 and len(fig.axes[0].lines) == 5
    assert out.exists() and out.stat().st_size > 0


def test_plot_variance_ratio_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    s1, s2 = rng.normal(size=30), rng.normal(size=30)
    dates = np.arange("1960-01", "1967-07", np.timedelta64(3, "M"),
                      dtype="datetime64[M]").astype("datetime64[D]")[:30]
    for kw in (dict(labels=["trend", "cycle"]), dict(dates=dates, annotation="synthetic")):
        out = tmp_path / "ratio.png"
        fig = tplot.plot_variance_ratio([s1, torch.from_numpy(s2)], path=str(out), **kw)
        _same_figure(fig, jplot.plot_variance_ratio([s1, s2], **kw))
        assert out.exists() and out.stat().st_size > 0


def test_plot_histograms_matches_jax(tmp_path):
    """The 2-wide panel of the posterior histograms of an SMC² θ-cloud
    (the port's posterior_histograms), the last panel blanked."""
    rng = np.random.default_rng(2)
    state = tsmc.SMC2State(theta=torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)),
                           log_omega=torch.from_numpy(rng.normal(size=64).astype(np.float32)),
                           particles=torch.zeros(64, 2, 1), log_w=torch.zeros(64, 2),
                           log_z=torch.zeros(64), ess=torch.tensor(1.0),
                           acc_ratio=torch.tensor(0.0), t=1, active_n=2, exchange_pending=False)
    hists = tsmc.analysis.posterior_histograms(torch.Generator().manual_seed(5), state,
                                               n_samples=500, bins=10)
    out = tmp_path / "hists.png"
    fig = tplot.plot_histograms(hists, var_names=["a", "b", "c"], path=str(out),
                                annotation="synthetic")
    ref = jplot.plot_histograms(hists, var_names=["a", "b", "c"], annotation="synthetic")
    _same_figure(fig, ref)
    assert len(fig.axes) == 4
    for a, b in zip(fig.axes, ref.axes):
        for pa, pb in zip(a.patches, b.patches, strict=True):
            np.testing.assert_array_equal(pa.get_path().vertices, pb.get_path().vertices)
    assert out.exists() and out.stat().st_size > 0


def test_plot_filtered_band_dates_and_annotation_match_jax(tmp_path):
    """The band plot on a calendar axis with the provenance annotation."""
    import matplotlib.dates as mdates

    rng = np.random.default_rng(1)
    y = np.cumsum(rng.normal(size=24))
    dates = np.arange("1960-01", "1966-01", np.timedelta64(3, "M"),
                      dtype="datetime64[M]").astype("datetime64[D]")[:24]
    out = tmp_path / "band.png"
    fig = tplot.plot_filtered_band(torch.from_numpy(y), y - 1, y, y + 1, dates=dates,
                                   annotation="synthetic stand-in", title="t", path=str(out))
    _same_figure(fig, jplot.plot_filtered_band(y, y - 1, y, y + 1, dates=dates,
                                               annotation="synthetic stand-in", title="t"))
    ax = fig.axes[0]
    assert isinstance(ax.xaxis.get_major_formatter(), mdates.DateFormatter)
    assert any("synthetic stand-in" in t.get_text() for t in fig.texts)
    np.testing.assert_array_equal(ax.collections[0].get_offsets()[:, 1], y)
    assert out.exists() and out.stat().st_size > 0


def test_plotting_needs_matplotlib_only_to_draw(monkeypatch):
    """Without matplotlib the module imports and a drawing call raises an
    ImportError naming it."""
    import importlib

    for mod in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    mod = importlib.reload(tplot)
    with pytest.raises(ImportError, match="matplotlib"):
        mod.plot_variance_ratio([np.zeros(3)])
