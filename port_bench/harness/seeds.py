"""Seeds derived from ``--seed``: one a call, one for each input stream."""
from __future__ import annotations

import numpy as np

STREAMS = {"warmup": 1, "inputs": 2, "sample": 3, "reference": 4}


def derive(seed: int, *path: int) -> int:
    """A 63-bit seed from (seed, path…): any whole number, however large."""
    state = np.random.SeedSequence([int(seed) & (2**128 - 1), *path]).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def call_seed(seed: int, index: int) -> int:
    """The generator seed of the window's call ``index`` (0, 1, …); index
    −1 is the warm-up call's."""
    return derive(seed, 0, index) if index >= 0 else stream_seed(seed, "warmup")


def stream_seed(seed: int, stream: str) -> int:
    return derive(seed, STREAMS[stream])
