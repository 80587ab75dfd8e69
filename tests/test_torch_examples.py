"""The port's examples (``sequential_monte_carlo_tpu_torch/examples``) at
small sizes on the CPU.

The inflation example at M and N of a few dozen over the full T=241 writes
every figure with its ``.npz`` series beside it, reads the series with the
native CSV loader, and at the UC model's θ̂ its filtered quantiles and FFBS
smoothed trend agree with the Kalman filter's Gaussian quantiles and
``kalman_smooth`` (the UC model is linear). The linear-Gaussian example
passes its own checks (the Kalman log Z, the exact-IS posterior oracle) at
small M and N. The two animations write their frames' series (and, with
figures, the GIF); the SV filter's log Z agrees with a grid filter's, and
the UC-SV filter's log Z and quantile bands with the JAX program's in
distribution (the random streams differ: DEVIATIONS.md §4)."""
import os

import numpy as np
import pytest
import torch

import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch.examples import (
    inflation,
    linear_gaussian,
    sv_animation,
    ucsv_animation,
)

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

TINY = {"uc": (32, 24, 3), "ucsv": (32, 24, 3)}  # (N, M, chain)
T = 241
STEMS = {
    "online": ["pce_inflation_trend_{}", "pce_inflation_cycle_{}", "theta_posterior_{}"],
    "post": ["pce_inflation_trend_{}_post", "pce_inflation_trend_{}_smoothed",
             "pce_inflation_trend_{}_postmix"],
}
# Monte-Carlo bounds at N=512, in units of the Kalman filtered (smoothed) sd,
# averaged over t (and the three quartiles): about twice the largest of 8
# seeds' at θ = (1.6, 0.19, 0.055) (0.08–0.10 filtered, 0.06–0.08 smoothed).
FILTER_TOL, SMOOTH_TOL = 0.2, 0.15
Z_QUARTILES = np.array([-0.6744897501960817, 0.0, 0.6744897501960817])


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("inflation"))
    return inflation.run_example(TINY, outdir, figures=True, device="cpu"), outdir


def test_inflation_example_writes_every_figure_and_series(tiny_run):
    out, outdir = tiny_run
    assert out["loader"] == "native"
    for name in ("uc", "ucsv"):
        for part, stems in STEMS.items():
            for stem in stems:
                for ext in ("npz", "png"):
                    path = os.path.join(outdir, stem.format(name) + "." + ext)
                    assert os.path.getsize(path) > 0, path
        with np.load(os.path.join(outdir, f"pce_inflation_trend_{name}.npz")) as z:
            assert z["median"].shape == (T - 1,) and np.all(np.isfinite(z["lower"]))
            assert np.all(z["lower"] <= z["upper"])
        with np.load(os.path.join(outdir, f"pce_inflation_trend_{name}_postmix.npz")) as z:
            assert z["median"].shape == (T,) and np.all(np.isfinite(z["median"]))
        online = out[name]["online"]
        assert online["state"].t == T and online["rejuvenations"] > 0
        assert online["var"].shape == (T - 1,) and out[name]["pf"]["xq"].shape == (T, 3)
    with np.load(os.path.join(outdir, "log_variance_ratio_inflation.npz")) as z:
        assert z["ratio_uc"].shape == z["ratio_ucsv"].shape == (T - 1,)
    assert os.path.getsize(os.path.join(outdir, "log_variance_ratio_inflation.png")) > 0


def test_inflation_no_figures_writes_only_series(tmp_path):
    """``--no-figures`` (the card's machine has no matplotlib): the series,
    no PNG."""
    _, y, _ = inflation.load_pce("cpu")
    inflation.run_posterior_smoothing("uc", tsmc.uc_model, _uc_state(), y, 16, str(tmp_path),
                                      figures=False, n_theta=2, n_paths=4)
    assert sorted(os.listdir(tmp_path)) == ["pce_inflation_trend_uc_postmix.npz"]


def _uc_state():
    rng = np.random.default_rng(3)
    theta = torch.from_numpy(np.stack([rng.normal(1.5, 0.2, 4), rng.uniform(0.1, 0.3, 4),
                                       rng.uniform(0.03, 0.1, 4)], 1).astype(np.float32))
    return tsmc.SMC2State(theta=theta, log_omega=torch.zeros(4), particles=torch.zeros(4, 2, 1),
                          log_w=torch.zeros(4, 2), log_z=torch.zeros(4), ess=torch.tensor(4.0),
                          acc_ratio=torch.tensor(0.0), t=T, active_n=2, exchange_pending=False)


def test_inflation_uc_at_theta_hat_matches_kalman(tiny_run, tmp_path):
    """At the tiny run's UC θ̂ = (x0, σε, ση), the example's filter and FFBS
    at N=512 against the exact filter and smoother of the filter's own target
    (x₁ ~ N(x0, σε), which the Kalman filter predicts from x0 with Σ0' = 0):
    the filtered quartiles' and the smoothed trend's errors, in sd units
    averaged over t, within FILTER_TOL and SMOOTH_TOL."""
    out, _ = tiny_run
    theta = out["uc"]["online"]["theta_hat"]
    _, y, _ = inflation.load_pce("cpu")
    pf = inflation.run_pf_at_theta_hat("uc", tsmc.uc_model(theta), y, 512, str(tmp_path),
                                       figures=False)
    x0, se, sn = theta.tolist()
    target = tsmc.univariate_linear_gaussian(1.0, 1.0, se, sn, x0=x0, sigma0=0.0, device="cpu")
    ms, ps, _, _ = tsmc.kalman_filter(target, y)
    m, s = ms[:, 0].numpy(), torch.sqrt(ps[:, 0, 0]).numpy()
    filt = np.abs(pf["xq"] - (m[:, None] + s[:, None] * Z_QUARTILES)) / s[:, None]
    rm, rp = tsmc.kalman_smooth(target, y)
    smooth = np.abs(pf["trend"] - rm[:, 0].numpy()) / torch.sqrt(rp[:, 0, 0]).numpy()
    assert filt.mean() < FILTER_TOL and smooth.mean() < SMOOTH_TOL, (filt.mean(), smooth.mean())
    assert np.all(np.isfinite(pf["trend_sd"])) and np.isfinite(pf["logz"])


def test_linear_gaussian_example_passes_its_checks():
    out = linear_gaussian.run(m=64, n=64, t=100, device="cpu")
    for k in ("dt", "smc2", "ibis"):
        assert torch.all((out[k] - out["oracle"]).abs() < linear_gaussian.POSTERIOR_TOL)


def test_linear_gaussian_example_check_can_fail():
    with pytest.raises(AssertionError, match="oracle"):
        linear_gaussian.check_posterior("x", torch.tensor([0.0, 0.0, 0.0]),
                                        torch.tensor([0.5, 0.9, 0.8]))


def test_sv_animation_series_and_log_z_against_grid_filter(tmp_path):
    """The SV animation at T=40, N=512 over 4 seeds: its .npz holds each
    frame's quantiles and histogram (the weighted histogram's masses sum to
    1), and the mean log Z sits within 5 standard errors of the point-mass
    grid filter's (chip_smoke.sv_grid_log_z)."""
    import chip_smoke

    t, bins = 40, 20
    runs = [sv_animation.run_animation(t=t, n=512, bins=bins, out=str(tmp_path / f"sv{s}.gif"),
                                       figures=False, device="cpu", seed=s) for s in range(4)]
    with np.load(runs[0]["npz"]) as z:
        assert z["q"].shape == (t, 3) and z["hist"].shape == (t, bins)
        assert z["y"].shape == z["x_true"].shape == (t,) and z["edges"].shape == (bins + 1,)
        assert np.all(z["q"][:, 0] <= z["q"][:, 2])
        np.testing.assert_allclose(z["hist"].sum(1), 1.0, rtol=1e-5)
    assert not any(p.suffix == ".gif" for p in tmp_path.iterdir())
    lz = np.array([r["log_z"] for r in runs])
    exact = chip_smoke.sv_grid_log_z(runs[0]["y"], *sv_animation.SV_THETA)
    assert abs(lz.mean() - exact) <= 5.0 * lz.std(ddof=1) / 2.0, (lz, exact)


def test_ucsv_animation_against_the_jax_program(tmp_path):
    """The UC-SV animation's filter at θ̂ on the PCE series, N=1024, 4 seeds
    each, against the JAX program's (filter_sequence, fused_resample="off"):
    the mean log Z within 5 combined standard errors, and the trend and both
    volatilities' 16/50/84% bands, seed-averaged, within 0.3 of JAX's mean
    band width averaged over t (about twice the gap seen at N=512)."""
    import jax
    import jax.numpy as jnp

    import sequential_monte_carlo_tpu as jsmc
    from sequential_monte_carlo_tpu.analysis import weighted_quantile as jax_quantile

    n, seeds = 1024, 4
    port = [ucsv_animation.run_animation(n=n, out=str(tmp_path / f"ucsv{s}.gif"),
                                         figures=False, device="cpu", seed=s)
            for s in range(seeds)]
    with np.load(port[0]["npz"]) as z:
        assert z["xq"].shape == z["seq"].shape == z["snq"].shape == (T, 3)
        assert z["y"].shape == z["dates"].shape == (T,)
    ps = jnp.array(ucsv_animation.PS)

    def summarize(st):
        w, x = jnp.exp(st.log_weights), st.particles
        return {"xq": jax_quantile(x[:, 0], w, ps),
                "seq": jax_quantile(jnp.exp(0.5 * x[:, 1]), w, ps),
                "snq": jax_quantile(jnp.exp(0.5 * x[:, 2]), w, ps)}

    model = jsmc.ucsv_model(jnp.asarray(ucsv_animation.THETA_HAT, jnp.float32))
    y = jnp.asarray(port[0]["y"])
    cfg = jsmc.PFConfig("systematic", 1.0, "off")
    ref = [jsmc.filter_sequence(jax.random.key(s), model, n, y, cfg, summarize=summarize)
           for s in range(seeds)]
    lp = np.array([r["log_z"] for r in port])
    lj = np.array([float(r[1]) for r in ref])
    se = np.sqrt(lp.var(ddof=1) / seeds + lj.var(ddof=1) / seeds)
    assert abs(lp.mean() - lj.mean()) <= 5.0 * se, (lp, lj)
    for k in ("xq", "seq", "snq"):
        qj = np.mean([np.asarray(r[2]["summary"][k]) for r in ref], 0)
        qp = np.mean([r[k] for r in port], 0)
        width = (qj[:, 2] - qj[:, 0]).mean()
        assert np.abs(qp - qj).mean() / width < 0.3, k


@pytest.mark.parametrize("program", ["sv", "ucsv"])
def test_animation_writes_gif_beside_series(tmp_path, program):
    """With figures (matplotlib here), the GIF and its .npz side by side."""
    out = str(tmp_path / f"{program}.gif")
    if program == "sv":
        sv_animation.run_animation(t=6, n=64, bins=8, out=out, device="cpu")
    else:
        ucsv_animation.run_animation(n=64, out=out, device="cpu", t=6)
    assert sorted(os.listdir(tmp_path)) == [f"{program}.gif", f"{program}.npz"]
    assert os.path.getsize(out) > 0
