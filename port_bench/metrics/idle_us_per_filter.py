"""The device's idle time under the program's ``smc.filter`` spans (a
masked filter: its eager init, its route's lookup and load, its replays;
children included) over the number of those spans, in µs (the profiler's
device trace against its host events). None where the trace holds no
``smc.filter``."""
from port_bench.metrics._spans import idle_under


def read(ctx):
    if ctx.trace is None:
        return None
    idle_s, count = idle_under(ctx.trace, "smc.filter")
    return idle_s * 1e6 / count if count else None
