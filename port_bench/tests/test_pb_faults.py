"""Whole runs on the CPU, with the look for a card skipped: a sound run is
correct, and each fault planted under the timed path
(:mod:`port_bench.harness.faults`), and the control, make ``correct``
false: the inner step's faults in both cells, the rejuvenation's in the
SMC² cell, which alone rejuvenates."""
import pytest
import torch

import sequential_monte_carlo_tpu_torch as smc
from port_bench.harness import faults

from ._runs import TINY, run

CASES = [(cell, name) for cell in sorted(TINY) for name in faults.INNER] + [
    ("smc2_ucsv_512x8192", name) for name in faults.SAMPLER]
# a shorter series where the run would rejuvenate at every step (the
# control's collapsed θ-weights, a cloud that never moves): at T = 241
# each call would refilter the whole history there
SHORT = {"smc2_ucsv_512x8192": {"t": 60}, "filters_lg_64x65536": {}}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, monkeypatch):
    faults.plant(smc, fault, monkeypatch.setattr)
    res = run(cell, overrides=SHORT[cell] if fault in faults.INNER else {})
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    res = run(cell, program="control", overrides=SHORT[cell])
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(TINY))
def test_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    import time

    from port_bench.harness import cli

    res = cli.run_cell(cell, 2**31 + 99, 3.0, True, "cuda", time.perf_counter(),
                       trace_calls=1)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
