"""Seconds from the first line of run.py to the window's first call:
imports, the CUDA context, the program's objects and inputs, the kernels'
libraries, and the warm-up call with its graph captures (host clock)."""


def read(ctx):
    return ctx.setup_s
