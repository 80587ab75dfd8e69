"""The 95th percentile (linear between order statistics) of the walls of
all the window's calls, in ms (host clock, each call ending in a
synchronize)."""
import numpy as np


def read(ctx):
    return float(np.percentile([wall for _, wall, _ in ctx.window["calls"]], 95)) * 1e3
