"""The least-time bounds that chip_smoke.py reports beside each kernel's
time, the per-particle work of the propagate functions they count, and
tools/sass_count.py's rule for the kernels' own work, which it holds against
it. On the CPU: no device is needed (the SM clock is given)."""
import importlib.util
import math
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke_under_test", "chip_smoke.py")
sc = _load("sass_count_under_test", "tools/sass_count.py")


@pytest.fixture
def clock(monkeypatch):
    monkeypatch.setattr(cs, "sm_clock_hz", lambda: 1.98e9)
    return 1.98e9


@pytest.mark.parametrize("model,s,normalize", [
    ("ucsv", 3, False), ("ucsv", 3, True), ("lg1", 1, True), ("lg1", 1, False), ("sv", 1, False)])
def test_propagate_bound_takes_the_slowest_pipe(clock, model, s, normalize):
    """The bound is the longest of the bytes and each pipe's work; at
    512×8192 every propagate function's bytes take longer than its
    instructions, multiplies and MUFU operations."""
    m, n = 512, 8192
    cost = cs.propagate_cost(m, n, s, 4, False, model, normalize)
    ms, by, what = cs.bound_ms(**cost)
    sm = cs.SMS * clock
    times = {"bytes": cost["nbytes"] / cs.PEAK_BYTES,
             "issue": cost["issue"] / (cs.INSTR_PER_CLOCK * sm),
             "imad": cost["imad"] / (cs.IMAD_PER_CLOCK * sm),
             "mufu": cost["mufu"] / (cs.MUFU_PER_CLOCK * sm)}
    assert (by, what) == ("bytes", "bytes")
    assert ms == pytest.approx(1e3 * max(times.values()))


@pytest.mark.parametrize("model,s,work", [
    ("ucsv", 3, (148.75, 34, 4)), ("lg1", 1, (87.75, 29, 1)), ("lg2", 2, (98.25, 29, 1)),
    ("sv", 1, (89.75, 29, 2)), ("lg3", 3, (158.75, 34, 2)), ("lg4", 4, (177.25, 34, 2)),
    ("lg5", 5, (277.75, 63, 3))])
def test_propagate_work_counts_the_function(model, s, work):
    """Per particle on the raw route: Philox (all four words for three or
    four normals, two for one or two; LG at dx = 5 adds a two-word call at
    the next counter for its fifth), Box–Muller, the update (LG: 2dx² + dx +
    3) and the 16-byte loads and stores."""
    assert cs.propagate_work(model, s, False, False, 8192) == pytest.approx(work)


def test_propagate_cost_picks_the_route_by_n():
    """The normalize adds its exp and sums; above 1024 particles the
    log-weights' second pass; the carry its read and add."""
    raw = cs.propagate_work("ucsv", 3, False, False, 1024)
    for n, extra in ((1000, 7), (1024, 7), (1025, 7.5)):
        issue, imad, mufu = cs.propagate_work("ucsv", 3, False, True, n)
        assert (issue - raw[0], imad, mufu) == (extra, raw[1], raw[2] + 1)
    cost = cs.propagate_cost(2, 8, 1, 4, True, "lg1", True)
    assert cost["nbytes"] == 4 * 2 * 8 * 4 + 4 * 2 * 6
    assert cost["issue"] == 2 * 8 * (cs.propagate_work("lg1", 1, False, True, 8)[0] + 1.25)


def test_resample_bound_is_bytes(clock):
    ms, by, what = cs.bound_ms(**cs.resample_cost(512, 8192, 3, grid=True))
    assert (by, what) == ("bytes", "bytes")
    assert ms == pytest.approx(1e3 * 4 * 512 * 8192 * 8 / cs.PEAK_BYTES)
    assert math.isclose(ms, 0.04006, rel_tol=1e-3)


# a thread of 4 particles: a fast path with a MUFU op and a slow path (a loop
# over local memory, skipped by a branch to its reconvergence point) and a
# branch to a subroutine's call; Philox's products by its round constants
# (0xd2511f53 printed as a negative immediate)
_SASS = [
    (0x00, "LDC R1, c[0x0][0x28]"),
    (0x10, "IMAD.WIDE.U32 R2, R3, -0x2daee0ad, RZ"),
    (0x20, "@!P0 BRA 0x70"),
    (0x30, "STL [R1], R2"),
    (0x40, "IADD3 R2, R2, 0x1, RZ"),
    (0x50, "@P1 BRA 0x30"),
    (0x60, "MOV R3, R2"),
    (0x70, "BSYNC B0"),
    (0x80, "MUFU.EX2 R5, R6"),
    (0x90, "@!P2 BRA 0xc0"),
    (0xa0, "MUFU.RCP R7, R5"),
    (0xb0, "STG.E desc[UR4][R8.64], R7"),
    (0xc0, "BSYNC B1"),
    (0xd0, "@P3 BRA 0xf0"),
    (0xe0, "CALL.REL.NOINC 0x120"),
    (0xf0, "BSYNC B2"),
    (0x100, "IMAD.HI.U32 R7, R8, 0xcd9e8d57, RZ"),
    (0x108, "IMAD R9, R8, R9, RZ"),
    (0x10c, "IMAD.MOV.U32 R10, RZ, RZ, R9"),
    (0x110, "EXIT"),
    (0x120, "FFMA R1, R2, R3, R4"),
    (0x130, "RET.REL.NODEC R20 0x0"),
    (0x140, "BRA 0x140"),
]


def test_sass_count_skips_slow_paths_and_subroutines():
    """Counted: everything but the looping local-memory path and the
    subroutine (and the call that only reaches it); the branch around a MUFU
    op and a store is work some particles do, so it counts. A wide product is
    two multiplies, a move on the multiply pipe none."""
    got = sc.count(_SASS, loop=False)
    counted = [a for a, _ in _SASS if a not in (0x30, 0x40, 0x50, 0x60, 0xe0, 0x120, 0x130)]
    assert got == {"issue": len(counted) / 4, "mul": 4 / 4, "philox_mul": 3 / 4, "mufu": 2 / 4}


def test_sass_count_takes_the_longest_loop():
    code = [(0x00, "S2R R0, SR_TID.X"), (0x10, "MUFU.EX2 R1, R0"), (0x20, "IMAD R2, R1, R1, RZ"),
            (0x30, "@P0 BRA 0x10"), (0x40, "FADD R3, R2, R2"), (0x50, "@P1 BRA 0x40"),
            (0x60, "EXIT")]
    assert sc.count(code, loop=True, particles=1) == {"issue": 3, "mul": 1, "philox_mul": 0,
                                                      "mufu": 1}
