"""The traced calls: torch.profiler over a few calls of the entry, kept
only where the trace holds both of its ends, and the numbers read from it.

A trace can lose its first device events or its tail (seen on this card
with the port's replays). So the traced span opens after a wait and
``HEAD_PADS`` long marker kernels (``torch.cuda._sleep``, named
``spin_kernel``), which the trace may lose, and closes with one short
marker and the wait; a trace that lost the short marker or every long one
is taken again with the wait doubled. The markers lie outside the span and
out of every number.
"""
from __future__ import annotations

import heapq
import re
import time

SETTLE_S = 0.2
ATTEMPTS = 4
HEAD_PADS = 64
HEAD_PAD_CYCLES = 200_000
MARKER = "spin_kernel"
SPAN = "port_bench.traced_calls"


class Trace:
    """What the readers take from a trace: the device's operations and the
    host's, in ns on the trace's clock, and the traced span."""

    def __init__(self, device_ops, host_ops, span):
        self.device_ops = device_ops  # [(name, start_ns, end_ns)], markers left out
        self.host_ops = host_ops  # [(name, start_ns, end_ns)]
        self.span = span  # (start_ns, end_ns) of SPAN

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e9

    def in_span(self):
        lo, hi = self.span
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device_ops if e > lo and s < hi]

    def kernels(self, names) -> list:
        """The device operations whose name holds one of ``names`` as a word."""
        pattern = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return [op for op in self.in_span() if pattern.search(op[0])]

    def busy_segments(self) -> list:
        """The union of the device's operations inside the span, merged."""
        merged = []
        for _, s, e in sorted(self.in_span(), key=lambda op: op[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_segments()) / 1e9

    def host_calls(self, name: str) -> int:
        lo, hi = self.span
        return sum(1 for n, s, e in self.host_ops if n == name and lo <= s and e <= hi)

    def idle_gaps(self) -> list:
        """[(label, seconds)] of every gap between the device's busy
        segments inside the span, labelled with the innermost runtime or
        aten call the host was in at the gap's middle."""
        lo, hi = self.span
        edges = [lo] + [x for seg in self.busy_segments() for x in seg] + [hi]
        calls = sorted((op for op in self.host_ops
                        if op[0].startswith(("cu", "aten::")) and op[0] != SPAN),
                       key=lambda op: op[1])
        gaps, active, j = [], [], 0  # active: a heap of (end, start, name)
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            while j < len(calls) and calls[j][1] <= mid:
                heapq.heappush(active, (calls[j][2], calls[j][1], calls[j][0]))
                j += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            label = min(active, key=lambda op: op[0] - op[1])[2] if active else "host, no call"
            gaps.append((label, (e - s) / 1e9))
        return gaps


def _ends(device_events) -> tuple:
    markers = [e - s for n, s, e in device_events if MARKER in n]
    long = sum(d >= 20_000 for d in markers)
    return long, len(markers) - long


def traced(torch, fn):
    """(fn()'s result, the Trace of its span) with host and device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(ATTEMPTS):
        settle = SETTLE_S * 2**attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            for _ in range(HEAD_PADS):
                torch.cuda._sleep(HEAD_PAD_CYCLES)
            torch.cuda.synchronize()
            with record_function(SPAN):
                out = fn()
                torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(settle)
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            row = (e.name(), e.start_ns(), e.end_ns())
            if e.device_type() == DeviceType.CUDA:
                # the span's own annotation is mirrored on the device's timeline
                if e.duration_ns() > 0 and e.name() != SPAN:
                    device.append(row)
            else:
                host.append(row)
        long, short = _ends(device)
        spans = [op for op in host if op[0] == SPAN]
        if long and short == 1 and len(spans) == 1:
            return out, Trace([op for op in device if MARKER not in op[0]], host,
                              (spans[0][1], spans[0][2]))
    raise RuntimeError(f"{ATTEMPTS} traces in a row lost an end")
