"""The whole inner step's share of the card's peak: its least time (the
larger of :mod:`port_bench.counts.inner_step`'s bytes over the HBM peak and
its operations over the float32 peak) times the traced calls' inner steps,
over the traced span's wall (host clock). It does not depend on which
kernels compute the step."""
from port_bench.counts import inner_step, peaks
from port_bench.metrics._shared import traced_steps


def read(ctx):
    if ctx.trace is None:
        return None
    sh = ctx.shape
    m, n = sh["rows"], sh["particles"]
    least = max(inner_step.nbytes(m, n, sh["planes"]) / peaks.HBM_BYTES_PER_S,
                inner_step.flops(m, n, sh["model"]) / peaks.F32_FLOPS_PER_S)
    return 100.0 * least * traced_steps(ctx) / ctx.trace.window_s
