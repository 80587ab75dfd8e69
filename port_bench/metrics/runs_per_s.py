"""Calls completed in the window over the window (host clock): posteriors
or likelihood banks a second."""


def read(ctx):
    return len(ctx.window["calls"]) / ctx.window["window_s"]
