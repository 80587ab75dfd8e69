"""The port's utils against the JAX package's: checkpoint and resume
(``utils/checkpoint.py``), the CSV loader (``utils/dataio.py``), the debug
guards (``utils/debug.py``) and the profiling helpers
(``utils/profiling.py``).

Checkpoints: ``SMC2State`` and ``IBISState`` round trips are bitwise and keep
the planar particle storage; a mid-run ``run_segmented`` split, saved with its
generator's state and resumed from the file, is bitwise the uninterrupted run
(the counterpart of ``tests/test_checkpoint.py``). The loader's native and
Python routes each give the JAX package's array, on the vendored PCE series
and on a CSV with blank and non-numeric cells. The debug tests are
``tests/test_debug.py``'s but for its jit case, which has no counterpart
(the port has no jit)."""
import json
import os

import numpy as np
import pytest
import torch

import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu.utils import dataio as jdataio
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
from sequential_monte_carlo_tpu_torch.ops.batched_filter import as_cloud
from sequential_monte_carlo_tpu_torch.utils import dataio
from sequential_monte_carlo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from sequential_monte_carlo_tpu_torch.utils.debug import (
    assert_finite_weights,
    check_state,
    debug_nans,
)
from sequential_monte_carlo_tpu_torch.utils.profiling import named_scope, trace

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCE = os.path.join(ROOT, "examples", "data", "pce_inflation.csv")


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def lg_setup():
    """The JAX checkpoint tests' problem: the LG model, its prior and a
    series simulated at θ* (T=30)."""
    prior = prior_from_spec(LG_PRIOR, device="cpu")
    _, y = tsmc.simulate(_gen(0), tsmc.lg_model(torch.tensor([0.5, 0.9, 0.8])), 30)
    return prior, y


def _planar(state) -> bool:
    return state.particles.transpose(1, 2).is_contiguous()


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in ((getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__))


def test_smc2_checkpoint_roundtrip_and_resume(lg_setup, tmp_path):
    """An SMC² state after 10 steps round-trips bitwise with its generator,
    keeps its planar particle storage, and one more step from it equals the
    live run's."""
    prior, y = lg_setup
    sampler = tsmc.SMC2(tsmc.lg_model, prior, tsmc.SMCConfig(n_particles=64, n_theta=32, chain=2))
    gen = _gen(1)
    state = sampler.init(gen, y)
    for _ in range(10):
        state, _ = sampler.step(gen, state, y)
    assert _planar(state)
    path = os.path.join(tmp_path, "ckpt.pt")
    save_checkpoint(path, state, gen)
    gen2 = _gen(99)
    restored = load_checkpoint(path, sampler.init(_gen(2), y), generator=gen2)
    assert _equal(restored, state) and _planar(restored)
    assert as_cloud(restored.particles).data_ptr() == restored.particles.data_ptr()
    live, _ = sampler.step(gen, state, y)
    resumed, _ = sampler.step(gen2, restored, y)
    assert _equal(live, resumed)


def test_ibis_checkpoint_roundtrip(lg_setup, tmp_path):
    prior, y = lg_setup
    ibis = tsmc.IBIS(tsmc.lg_model, prior, tsmc.SMCConfig(n_theta=32, chain=2))
    state = ibis.init(_gen(2), y)
    path = os.path.join(tmp_path, "ibis.pt")
    save_checkpoint(path, state)
    restored = load_checkpoint(path, state)
    assert _equal(restored, state)
    with pytest.raises(ValueError, match="no generator state"):
        load_checkpoint(path, state, generator=_gen(0))
    with pytest.raises(ValueError, match="IBISState"):
        tsmc_state = tsmc.SMC2(tsmc.lg_model, prior,
                               tsmc.SMCConfig(n_particles=16, n_theta=8)).init(_gen(0), y)
        load_checkpoint(path, tsmc_state)


def test_checkpoint_file_loads_with_weights_only(lg_setup, tmp_path):
    """The file is a plain dict (no pickled class), which torch.load takes
    with weights_only=True."""
    prior, y = lg_setup
    state = tsmc.SMC2(tsmc.lg_model, prior, tsmc.SMCConfig(n_particles=16, n_theta=8)).init(
        _gen(0), y)
    path = os.path.join(tmp_path, "s.pt")
    save_checkpoint(path, state, _gen(3))
    data = torch.load(path, weights_only=True)
    assert data["type"] == "SMC2State" and set(data["fields"]) == set(state.__dataclass_fields__)


def test_midrun_segmented_checkpoint_resume_bitwise(lg_setup, tmp_path):
    """A segmented grow-mode run with doublings (the JAX test's
    configuration), saved at step k with its generator — at the step that
    raised a doubling not yet serviced, and at 5 and 17 — and resumed from
    the file: the final state and the concatenated step infos equal the
    uninterrupted run's bitwise; resuming a finished run returns zero-length
    infos and the state as it was."""
    prior, y = lg_setup
    cfg = tsmc.SMCConfig(n_particles=64, n_theta=32, chain=2, ess_threshold=0.5,
                         acc_threshold=1.1, exchange_max_n=128)
    sampler = tsmc.SMC2(tsmc.lg_model, prior, cfg)
    full, full_infos = sampler.run_segmented(_gen(1), y, segment_size=8)
    assert full.active_n > 64

    gen, st, k_pend = _gen(1), None, None
    st = sampler.init(gen, y)
    for i in range(1, y.shape[0] - 1):
        st, info = sampler.step(gen, st, y)
        if st.exchange_pending:
            k_pend = i
            break
        st = sampler.maybe_exchange(gen, st, y, info)
    assert k_pend is not None

    for k in (k_pend, 5, 17):
        gen = _gen(1)
        s1, i1 = sampler.run_segmented(gen, y, segment_size=8, max_steps=k)
        assert s1.exchange_pending == (k == k_pend)
        path = os.path.join(tmp_path, f"mid{k}.pt")
        save_checkpoint(path, s1, gen)
        gen2 = _gen(123)
        restored = load_checkpoint(path, sampler.init(_gen(0), y), generator=gen2)
        assert _planar(restored)
        s2, i2 = sampler.run_segmented(gen2, y, segment_size=8, state=restored)
        assert _equal(s2, full)
        for a, b, c in zip(i1, i2, full_infos):
            assert torch.equal(torch.cat([a, b]), c)
    s3, i3 = sampler.run_segmented(gen2, y, segment_size=8, state=s2)
    assert i3.ess.shape == (0,) and _equal(s3, s2)


# -- the CSV loader -----------------------------------------------------------

def test_native_loader_builds_into_the_package(tmp_path):
    """The native loader is built from csrc/dataio.cpp into the port's
    _build/ (a host compiler is present here), never into csrc/."""
    assert dataio.native_loader_available()
    so = dataio.library_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "sequential_monte_carlo_tpu_torch"


def _routes(path: str, col: int):
    native = dataio._read_native(dataio._lib(), path, col, ",")
    return {"native": native, "python": dataio._read_python(path, col, ","),
            "read_csv_column": dataio.read_csv_column(path, col)}


def test_read_csv_column_matches_jax_on_the_pce_series():
    ref = jdataio.read_csv_column(PCE, 1)
    assert ref.shape == (241,)
    for route, got in _routes(PCE, 1).items():
        assert got is not None, route
        np.testing.assert_array_equal(got, ref, err_msg=route)


def test_read_csv_column_blank_and_non_numeric_cells(tmp_path):
    """Blank and non-numeric cells read as NaN on both routes, as in the JAX
    package; a row short of the column reads NaN too."""
    path = os.path.join(tmp_path, "odd.csv")
    rng = np.random.default_rng(5)
    vals = rng.normal(size=6)
    with open(path, "w") as f:
        f.write("date,value,other\n")
        f.write(f"2000-01-01,{vals[0]!r},1\n")
        f.write("2000-04-01,,2\n")
        f.write(f"2000-07-01,{vals[1]!r},3\n")
        f.write("2000-10-01,n/a,4\n")
        f.write(f"2001-01-01,{vals[2]!r},5\n")
    ref = jdataio.read_csv_column(path, 1)
    assert np.isnan(ref[1]) and np.isnan(ref[3])
    for route, got in _routes(path, 1).items():
        np.testing.assert_array_equal(got, ref, err_msg=route)
    for route, got in _routes(path, 2).items():
        np.testing.assert_array_equal(got, jdataio.read_csv_column(path, 2), err_msg=route)


# -- debug (tests/test_debug.py, but for its jit case) ------------------------

def test_assert_finite_weights_passes():
    lw = torch.log(torch.full((4, 8), 0.125))
    assert torch.equal(assert_finite_weights(lw), lw)


def test_assert_finite_weights_raises_eager():
    lw = torch.full((2, 8), -torch.inf)
    lw[0] = 0.0  # row 1 fully degenerate
    with pytest.raises(FloatingPointError, match="1 fully degenerate"):
        assert_finite_weights(lw)
    with pytest.raises(FloatingPointError, match="2 fully degenerate"):
        assert_finite_weights(torch.full((2, 8), torch.nan))


def test_check_state_reports_finite_fraction(lg_setup):
    diag = check_state({"w": torch.tensor([0.5, torch.nan]), "t": torch.tensor(3)})
    (k,) = [k for k in diag if "w" in k]
    assert diag[k]["finite_frac"] == 0.5
    prior, y = lg_setup
    state = tsmc.SMC2(tsmc.lg_model, prior, tsmc.SMCConfig(n_particles=16, n_theta=8)).init(
        _gen(0), y)
    diag = check_state(state)
    assert diag["state.particles"]["finite_frac"] == 1.0 and "state.t" not in diag


def test_debug_nans_raises_names_the_op_and_restores():
    from torch.overrides import _get_current_function_mode_stack

    before = len(_get_current_function_mode_stack())
    x = torch.tensor([1.0, -1.0])
    with debug_nans(True):
        assert len(_get_current_function_mode_stack()) == before + 1
        torch.exp(x)
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
    assert len(_get_current_function_mode_stack()) == before
    with debug_nans(False):
        assert torch.isnan(torch.log(x)).any()
    assert len(_get_current_function_mode_stack()) == before


# -- profiling ----------------------------------------------------------------

def test_trace_writes_a_named_scope(tmp_path):
    logdir = os.path.join(tmp_path, "trace")
    with trace(logdir) as prof:
        with named_scope("smc_test_scope"):
            torch.ones(64).cumsum(0)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "smc_test_scope" for e in events)
    assert any(e.key == "smc_test_scope" for e in prof.key_averages())
