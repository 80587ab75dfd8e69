"""The port's launcher (parallel/launch.py) across two processes — the twin
of tests/test_multihost.py: two OS processes join through
``initialize_distributed`` (gloo on the CPU, a ``file://`` store), build
``make_global_mesh`` over both and run ShardedSMC2 (the JAX worker's LG run:
M=32, N=64, T=24, chain=2); both print identical t, ESS and θ̂, equal to
the one-process run's (tests/torch_dist_worker.py, suites "multihost" and
"plain")."""
import json

import numpy as np

from torch_dist_worker import run_world, start_world, wait_world


def test_two_process_smc2(tmp_path):
    (tmp_path / "plain").mkdir()
    plain = start_world("plain", 1, tmp_path / "plain")
    ranks, outs = run_world("multihost", 2, tmp_path)
    ref = wait_world(plain)[0][0]
    lines = [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
             for out in outs]
    assert {ln["process"] for ln in lines} == {0, 1}
    assert all(ln["backend"] == "gloo" for ln in lines)
    assert lines[0]["t"] == lines[1]["t"] == 24
    assert lines[0]["ess"] == lines[1]["ess"]
    assert lines[0]["theta_hat"] == lines[1]["theta_hat"]
    for r in ranks:
        for k in ("t", "ess", "theta_hat"):
            np.testing.assert_array_equal(r[f"multihost/{k}"], ref[f"multihost/{k}"])
