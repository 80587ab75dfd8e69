"""The count functions against bytes and operations worked by hand."""
import math

from port_bench.counts import inner_step, peaks, propagate, resample


def test_resample_bytes_by_hand():
    # K1 at 512 x 8192, 3 planes: weights (1 plane) + cloud read (3) + written (3), and u0
    assert resample.nbytes(512, 8192, 3) == 4 * 512 * 8192 * 7 + 4 * 512 == 117_442_560
    # K3 at 64 x 65,536, 1 plane: weights, cloud in and out, the grid u
    assert resample.nbytes(64, 65536, 1, grid=True) == 4 * 64 * 65536 * 4 == 67_108_864
    assert resample.flops(2, 8) == 2 * 8 * (3 + 3)


def test_propagate_bytes_by_hand():
    # K2 UC-SV normalized: 3 planes in, 3 out, log-weights out; (γε, γη) in, lse and ess out
    assert propagate.nbytes(512, 8192, 3, 2) == 4 * 512 * 8192 * 7 + 4 * 512 * 4
    # K2 LG with the carry: 1 plane in and out, log-weights out, carry in
    assert propagate.nbytes(64, 65536, 1, 3, carry=True) == 4 * 64 * 65536 * 4 + 4 * 64 * 5
    # K6 raw: no lse, no ess
    assert propagate.nbytes(8, 16, 3, 2, normalize=False) == 4 * 8 * 16 * 7 + 4 * 8 * 2
    assert propagate.flops(1, 1, "ucsv") == 3 * 6 + 14 + 7
    assert propagate.flops(1, 1, "lg", normalize=False) == 6 + 6


def test_inner_step_least_time_by_hand():
    # UC-SV 512 x 8192: 32 bytes a particle (3 planes + log w, read and written)
    nbytes = inner_step.nbytes(512, 8192, 3)
    assert nbytes == 32 * 512 * 8192 == 134_217_728
    assert math.isclose(nbytes / peaks.HBM_BYTES_PER_S, 40.06e-6, rel_tol=1e-3)
    # bytes bind: the operations take a tenth of that time
    flops_s = inner_step.flops(512, 8192, "ucsv") / peaks.F32_FLOPS_PER_S
    assert flops_s < nbytes / peaks.HBM_BYTES_PER_S / 5
    assert inner_step.nbytes(64, 65536, 1) == 16 * 64 * 65536
