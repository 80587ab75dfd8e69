"""Build and load the package's CUDA C++ kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` of the package for Hopper (``sm_90a``),
one process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``. The library
is keyed by a hash of the sources (headers included) and flags and lives in
the package's ``_build/`` directory, so a fresh checkout builds it once on its
first kernel launch and later processes load it. Nothing is downloaded: the
sources in the package are the only input. (PyTorch's
``cpp_extension.load`` is not used: a source that includes PyTorch's headers
takes minutes to compile; this library takes seconds.)

It also keeps the registry of the wrappers' launch counters
(:func:`launch_counter`): each wrapper registers its counter once, where it
defines it, and whoever moves the counts as a whole (a captured CUDA graph's
replay, ``ops/graphs.py``) reads and adds the registry.
"""
from __future__ import annotations

import collections
import copy
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels are built from the package's csrc/ at first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsmc_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the first failure's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if this checkout has none."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
        srcs = [src for src in _sources() if src.suffix == ".cu"]
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
        _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(srcs, objs)])
        tmp = so.with_name(f"{so.name}.{tag}")
        _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        for obj in objs:
            obj.unlink()
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.smc_resample_count.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.smc_resample_sorted.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    for name in ("smc_resample_count", "smc_resample_sorted"):
        getattr(lib, name).restype = i32
    lib.smc_ucsv_propagate.argtypes = [ptr, ptr, ptr, i64, ptr, i64, ptr, i64, i64,
                                       ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.smc_ucsv_propagate.restype = i32
    for name in ("smc_resample_count_max_n", "smc_resample_sorted_max_n"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.smc_error_string.argtypes = [i32]
    lib.smc_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.smc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# -- launch counters ---------------------------------------------------------

#: (wrapper, attribute) of every kernel wrapper's launch counter: an int, or a
#: ``collections.Counter`` by kernel instance
LAUNCH_COUNTERS: list = []


def launch_counter(wrapper, attr: str = "launches", start=0) -> None:
    """Give ``wrapper`` its launch counter ``wrapper.<attr> = start`` and
    register it. The wrapper adds one where it launches its kernel, and
    nowhere else."""
    setattr(wrapper, attr, start)
    LAUNCH_COUNTERS.append((wrapper, attr))


def launch_counts() -> list:
    """A copy of every registered counter, in the registry's order."""
    return [copy.copy(getattr(w, a)) for w, a in LAUNCH_COUNTERS]


def set_launch_counts(counts: list) -> None:
    """Set every registered counter to ``counts`` (:func:`launch_counts`'s)."""
    for (w, a), c in zip(LAUNCH_COUNTERS, counts, strict=True):
        if isinstance(c, collections.Counter):  # in place: callers hold it
            getattr(w, a).clear()
            getattr(w, a).update(c)
        else:
            setattr(w, a, c)


def add_launch_counts(delta: list, times: int = 1) -> None:
    """Add ``times`` × ``delta``, a difference of two :func:`launch_counts`,
    to the registered counters (a graph's launches, once a replay)."""
    for (w, a), d in zip(LAUNCH_COUNTERS, delta, strict=True):
        if isinstance(d, collections.Counter):
            getattr(w, a).update({k: v * times for k, v in d.items()})
        else:
            setattr(w, a, getattr(w, a) + d * times)
