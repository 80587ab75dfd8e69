"""Whole runs on the CPU, with the look for a card skipped: a sound run is
correct, and each fault planted under the timed path
(:mod:`port_bench.harness.faults`), and the control, make ``correct``
false: the inner step's faults in every cell, the rejuvenation's in every
cell whose entry is SMC², which alone rejuvenates. The cells and their
sizes are the files of ``cells/``."""
import pytest
import torch

import sequential_monte_carlo_tpu_torch as smc
from port_bench.harness import faults

from ._runs import cells, entry, run, sizes

CASES = [(cell, name) for cell in cells() for name in faults.INNER] + [
    (cell, name) for cell in cells() if entry(cell) == "smc2" for name in faults.SAMPLER]


@pytest.mark.parametrize("cell", cells())
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, monkeypatch):
    faults.plant(smc, fault, monkeypatch.setattr)
    res = run(cell, overrides=sizes(cell)["short"] if fault in faults.INNER else {})
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("model,theta", [("lg_model", [0.5, 0.9, 0.8]),
                                         ("ucsv_model", [0.2, 3.0, 0.2, 0.3])])
@pytest.mark.parametrize("algorithm", ["bootstrap", "apf"])
@pytest.mark.parametrize("fault", faults.INNER)
def test_inner_faults_reach_every_step(model, theta, algorithm, fault, monkeypatch):
    """Each inner fault, planted on the batched filter's step, changes a
    bank's filter as it says, for the bootstrap and the auxiliary filter,
    on either model: ``answer`` adds 0.5 a step to row 0's log Z alone,
    ``half`` leaves each row's final weights summing to other than 1,
    ``unchanged`` leaves the cloud where the init put it."""
    m, n, t = 4, 64, 6
    y = torch.linspace(2.0, 3.0, t)
    bank = getattr(smc, model)(torch.tensor([theta] * m))
    config = smc.PFConfig("systematic", 1.0, algorithm=algorithm)

    def filt():
        return smc.batched_log_likelihood(torch.Generator().manual_seed(7), bank, n, m, y, config)

    particles, _, log_z = filt()
    init = smc.ops.batched_filter.batched_pf_init(torch.Generator().manual_seed(7), bank, n, m,
                                                  y[0], config)
    faults.plant(smc, fault, monkeypatch.setattr)
    f_particles, f_log_w, f_log_z = filt()
    if fault == "answer":
        assert torch.allclose(f_log_z - log_z, torch.tensor([0.5 * (t - 1), 0, 0, 0]), atol=1e-4)
    elif fault == "half":
        assert (torch.logsumexp(f_log_w.double(), dim=1).abs() > 0.1).all()
    else:
        assert torch.equal(f_particles, init.particles)
        assert not torch.equal(particles, init.particles)


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(cell):
    res = run(cell, program="control", overrides=sizes(cell)["short"])
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cells())
def test_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    import time

    from port_bench.harness import cli

    res = cli.run_cell(cell, 2**31 + 99, 3.0, True, "cuda", time.perf_counter(),
                       trace_calls=1)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
