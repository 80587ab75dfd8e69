"""The rejuvenations' share of a posterior's wall: Σ of the program's
``smc.rejuvenate`` spans (``SMC2._resample_move``: the θ-resample and the
``chain`` PMMH moves, each a masked filter over the history) over Σ of its
``smc.run`` spans, in the traced calls, in % (the profiler's host events,
on the device trace's clock). A span is the host's time: nothing in a
rejuvenation reads the device, so the device finishes the replays it
issued after the span has closed, inside the next online step's flag read.
None where the trace holds no ``smc.run``."""
from port_bench.metrics._spans import span_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    run = span_seconds(ctx.trace, "smc.run")
    if run <= 0:
        return None
    return 100.0 * span_seconds(ctx.trace, "smc.rejuvenate") / run
