"""CSV column loader — counterpart of
``sequential_monte_carlo_tpu/utils/dataio.py``: the native mmap column
reader of the repo's ``csrc/dataio.cpp`` through ``ctypes``, with a
pure-Python route that gives the same array.

The native library is built at first use with the host C++ compiler (``$CXX``,
else ``c++`` or ``g++`` on the PATH) from ``csrc/dataio.cpp`` into the
package's ``_build/`` (keyed by a hash of the source and flags), never into
``csrc/``. Without a compiler or the source, or if the build fails, the
Python route reads the file.
"""
from __future__ import annotations

import csv
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "csrc" / "dataio.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-shared")


def _compiler():
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def library_path() -> Path:
    """Where the loader built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsmcdataio_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded native loader, built first if this checkout has none;
    None where it cannot be built or loaded."""
    cxx = _compiler()
    if not SOURCE.exists() or cxx is None:
        return None
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.smc_csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                 ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.smc_csv_dims.restype = ctypes.c_int
    lib.smc_csv_read_column.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int64,
        np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"), ctypes.c_int64]
    lib.smc_csv_read_column.restype = ctypes.c_int
    return lib


def native_loader_available() -> bool:
    return _lib() is not None


def _read_native(lib, path: str, col: int, delim: str):
    """The column through the native loader, or None where it refuses the
    file or the column. A row without the column reads as NaN, as on the
    Python route."""
    n_rows, n_cols = ctypes.c_int64(), ctypes.c_int64()
    if lib.smc_csv_dims(path.encode(), delim.encode(), ctypes.byref(n_rows),
                        ctypes.byref(n_cols)) != 0 or not 0 <= col < n_cols.value:
        return None
    out = np.full(n_rows.value, np.nan, dtype=np.float64)
    if lib.smc_csv_read_column(path.encode(), delim.encode(), col, out, n_rows.value) != 0:
        return None
    return out


def _read_python(path: str, col: int, delim: str) -> np.ndarray:
    """The column through Python's csv module: blank lines skipped, empty
    and non-numeric cells NaN."""
    vals = []
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=delim)
        next(reader, None)
        for row in reader:
            if not row:
                continue
            try:
                vals.append(float(row[col]))
            except (ValueError, IndexError):
                vals.append(float("nan"))
    return np.asarray(vals, dtype=np.float64)


def read_csv_column(path: str, col: int, delim: str = ",") -> np.ndarray:
    """Read one numeric column (0-indexed, header skipped) as float64."""
    lib = _lib()
    out = None if lib is None else _read_native(lib, str(path), col, delim)
    return _read_python(str(path), col, delim) if out is None else out
