"""Σ over the window's calls of rows × particles × inner steps, over the
window (host clock): filtering work a second at the cell's budget."""


def read(ctx):
    return sum(rec["particle_steps"] for _, _, rec in ctx.window["calls"]) / ctx.window["window_s"]
