"""The program's spans (``smc.*``, ``utils/profiling.py::named_scope`` in
the port) read from the profiler's host events, and the device's idle time
put down to them: the readers of the span metrics share these.

The spans of one thread nest, so each instant of the traced span lies in a
stack of them, outermost first. An idle piece is a stretch of the traced
span in which the device runs nothing (between ``Trace.busy_segments()``)
and the stack of spans stays the same; the pieces cover the idle time
exactly, in the trace's integer ns.
"""
from __future__ import annotations

import sys

PREFIX = "smc."
OUTSIDE = "outside the program"
GRAPHS = "sequential_monte_carlo_tpu_torch.ops.graphs"


def spans(trace) -> list:
    """[(name, start_ns, end_ns)] of the program's spans inside the traced
    span, clipped to it, in order of start (an outer span before the inner
    one that starts with it)."""
    lo, hi = trace.span
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in trace.host_ops
              if n.startswith(PREFIX) and e > lo and s < hi]
    return sorted(inside, key=lambda op: (op[1], -op[2]))


def idle_segments(trace) -> list:
    """[(start_ns, end_ns)] of the traced span where the device is idle."""
    lo, hi = trace.span
    edges = [lo] + [x for seg in trace.busy_segments() for x in seg] + [hi]
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def idle_pieces(trace) -> list:
    """[(start_ns, end_ns, (span names, outermost first))], in order: the
    idle time split where the stack of spans changes."""
    todo = spans(trace)
    pieces, stack, j = [], [], 0
    for a, b in idle_segments(trace):
        t = a
        while t < b:
            while j < len(todo) and todo[j][1] <= t:
                while stack and stack[-1][2] <= todo[j][1]:
                    stack.pop()
                stack.append(todo[j])
                j += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            nxt = min([b] + ([stack[-1][2]] if stack else [])
                      + ([todo[j][1]] if j < len(todo) else []))
            pieces.append((t, nxt, tuple(n for n, _, _ in stack)))
            t = nxt
    return pieces


def idle_by_span(trace) -> dict:
    """{innermost span's name, or OUTSIDE: idle seconds}; the values sum
    to the traced span's idle time."""
    out = {}
    for s, e, names in idle_pieces(trace):
        key = names[-1] if names else OUTSIDE
        out[key] = out.get(key, 0) + e - s
    return {k: v / 1e9 for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def idle_under(trace, name: str, without: str | None = None) -> tuple:
    """(idle seconds inside spans named ``name``, children included, less
    those inside a span named ``without``; the number of ``name`` spans)."""
    ns = sum(e - s for s, e, names in idle_pieces(trace)
             if name in names and (without is None or without not in names))
    return ns / 1e9, sum(1 for n, _, _ in spans(trace) if n == name)


def span_seconds(trace, name: str) -> float:
    """Σ of the wall of the spans named ``name`` in the traced span."""
    return sum(e - s for n, s, e in spans(trace) if n == name) / 1e9


def graph_stats():
    """The program's ``ops/graphs.py::graph_stats`` where the run loaded the
    program and the program counts them, else None (the control, or a
    program without the counters)."""
    module = sys.modules.get(GRAPHS)
    return None if module is None else getattr(module, "graph_stats", None)
