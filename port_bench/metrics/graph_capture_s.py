"""Seconds the program spent capturing and instantiating its CUDA graphs
(``ops/graphs.py::graph_stats``: ``capture_s`` + ``instantiate_s``) over
the run: all in set-up, where the warm-up call builds every route the cell
uses and the window evicts none (``graph_stats["evictions"]``). A part of
``setup_s``. None where the program does not count them or captured
nothing (the control, the CPU)."""
from port_bench.metrics._spans import graph_stats


def read(ctx):
    stats = graph_stats()
    seconds = 0.0 if stats is None else stats["capture_s"] + stats["instantiate_s"]
    return seconds if seconds > 0 else None
