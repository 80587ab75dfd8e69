"""One minus the union of the device's operations over the traced span, in
% (the profiler's device trace; the union, since Σ of durations counts
overlapping work twice)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
