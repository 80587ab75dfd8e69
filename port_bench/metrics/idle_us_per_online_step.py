"""The device's idle time under the program's ``smc.online_step`` spans,
less the time under their ``smc.rejuvenate`` children, over the number of
online steps, in µs (the profiler's device trace against its host events):
the flag read, the load and the replay of a step. None where the trace
holds no ``smc.online_step``."""
from port_bench.metrics._spans import idle_under


def read(ctx):
    if ctx.trace is None:
        return None
    idle_s, count = idle_under(ctx.trace, "smc.online_step", without="smc.rejuvenate")
    return idle_s * 1e6 / count if count else None
