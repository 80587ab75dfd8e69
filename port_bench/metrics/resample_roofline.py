"""The resample + gather function's share of its bound: its bytes a call
(:mod:`port_bench.counts.resample`, at the cell's rows, particles and
planes) over the HBM peak, times the calls, over the device time of the
kernels that compute it (K1 ``resample_count_kernel``, K3
``resample_sorted_kernel``: ``csrc/resample_count.cu``,
``csrc/resample_sorted.cu``)."""
from port_bench.counts import peaks, resample
from port_bench.metrics._shared import RESAMPLE_KERNELS


def read(ctx):
    if ctx.trace is None:
        return None
    ops = ctx.trace.kernels(RESAMPLE_KERNELS)
    if not ops:
        return None
    m, n, c = ctx.shape["rows"], ctx.shape["particles"], ctx.shape["planes"]
    need = sum(resample.nbytes(m, n, c, grid="resample_sorted_kernel" in name)
               for name, _, _ in ops) / peaks.HBM_BYTES_PER_S
    took = sum(e - s for _, s, e in ops) / 1e9
    return 100.0 * need / took
