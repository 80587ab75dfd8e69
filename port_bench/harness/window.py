"""The measured window: a closed loop of calls to the cell's entry."""
from __future__ import annotations

import time


def sync(torch, device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def run(torch, entry, seconds: float, device: str) -> dict:
    """Calls ``entry.call(i)`` for i = 0, 1, … one after another,
    each ending in a synchronize, until ``seconds`` have passed since the
    first call's start. Only calls that end inside that time count; the
    window is the host time from the first call's start to the last counted
    call's end. Returns {"calls": [(index, wall_s, record)], "window_s",
    "next": an index no call of the window used}.
    ``entry.after`` reads what a call did (its inner steps and its outputs)
    once it has ended, inside the window."""
    calls = []
    t0 = time.perf_counter()
    end = t0
    i = 0
    while True:
        start = time.perf_counter()
        out = entry.call(i)
        sync(torch, device)
        stop = time.perf_counter()
        if stop - t0 > seconds and calls:
            break
        calls.append((i, stop - start, entry.after(i, out)))
        end = stop
        i += 1
        if stop - t0 > seconds:
            break
    return {"calls": calls, "window_s": end - t0, "next": i + 1}
