"""Graph launches over the inner steps they ran, from the program's own
counters (``ops/graphs.py::graph_stats``: ``replays`` over
``replayed_steps``), over every call of the run — the warm-up's, the
window's and the traced ones, which the counters do not tell apart. In
both cells every inner step runs on a route, so it is the in-program twin
of ``graph_launches_per_inner_step``. None where the program does not
count them or replayed nothing (the control, the CPU)."""
from port_bench.metrics._spans import graph_stats


def read(ctx):
    stats = graph_stats()
    if not stats or not stats.get("replayed_steps"):
        return None
    return stats["replays"] / stats["replayed_steps"]
