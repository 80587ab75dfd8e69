"""Device time of every operation in the traced span that is not the
resample's or the propagate's kernel, in µs an inner step (the profiler's
device trace, Σ of durations)."""
from port_bench.metrics._shared import PROPAGATE_KERNELS, RESAMPLE_KERNELS, traced_steps


def read(ctx):
    if ctx.trace is None:
        return None
    kernels = set(ctx.trace.kernels(RESAMPLE_KERNELS + PROPAGATE_KERNELS))
    glue_ns = sum(op[2] - op[1] for op in ctx.trace.in_span() if op not in kernels)
    return glue_ns / 1e3 / traced_steps(ctx)
