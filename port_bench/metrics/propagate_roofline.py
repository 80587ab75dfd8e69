"""The propagate + reweight (+ normalize) function's share of its bound:
its bytes a call (:mod:`port_bench.counts.propagate`, at the cell's rows,
particles, planes and parameters; K6's raw route without the normalize's
outputs) over the HBM peak, times the calls, over the device time of the
kernels that compute it (K2 ``step_kernel``, ``kernels/propagate.py``; K6
``ucsv_*_kernel``, ``csrc/ucsv_propagate.cu``)."""
from port_bench.counts import peaks, propagate
from port_bench.metrics._shared import PROPAGATE_KERNELS


def read(ctx):
    if ctx.trace is None:
        return None
    ops = ctx.trace.kernels(PROPAGATE_KERNELS)
    if not ops:
        return None
    sh = ctx.shape
    need = 0.0
    for name, _, _ in ops:
        raw = "ucsv_raw_kernel" in name
        need += propagate.nbytes(sh["rows"], sh["particles"], sh["planes"], sh["step_params"],
                                 carry=sh["carry"] and not raw, normalize=not raw)
    took = sum(e - s for _, s, e in ops) / 1e9
    return 100.0 * need / peaks.HBM_BYTES_PER_S / took
