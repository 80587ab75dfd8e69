"""``cudaGraphLaunch`` calls in the traced span over the traced calls'
inner steps (the profiler's host trace)."""
from port_bench.metrics._shared import traced_steps


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.host_calls("cudaGraphLaunch") / traced_steps(ctx)
