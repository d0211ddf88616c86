"""ctypes binding of the native CSV parser ``fastcsv.cpp`` (port of
``hlax/native/io.py``).

``g++ -O3 -march=native -shared -fPIC`` builds ``build/libfastcsv.so`` at
the repository root (``ops/cuda_build.py``'s build directory) on first use;
a library older than its source is rebuilt.  When the build fails, its
compiler output is printed once and every read takes the plain-Python
parser, as in hlax; so does a file the native parser rejects (return codes
4-7: a row longer than the probed shape, a non-numeric line after the
first, ragged rows).  ``native_available()`` says whether the library
loaded, and ``PARSES`` counts which parser read each file.
"""

from __future__ import annotations

import csv
import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from hlax_torch.ops.cuda_build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "fastcsv.cpp"
LIB = BUILD_DIR / "libfastcsv.so"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

# files read by each parser since the last reset_parses()
PARSES = {"native": 0, "fallback": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def reset_parses() -> None:
    for k in PARSES:
        PARSES[k] = 0


def _build() -> None:
    """Compile ``SRC`` into ``LIB`` (through a file of this process's own,
    renamed into place, so concurrent builds never load half a file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libfastcsv.so.tmp{os.getpid()}"
    subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                   check=True, capture_output=True, text=True, timeout=120)
    os.replace(tmp, LIB)


def _load() -> Optional[ctypes.CDLL]:
    """The loaded parser, built first if it is missing or older than its
    source; None (after printing why, once) when that fails."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not LIB.is_file() or (LIB.stat().st_mtime
                                     < SRC.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(LIB))
        except subprocess.CalledProcessError as exc:
            _build_failed = True
            print(f"hlax_torch: building {LIB} failed; CSV files are read by "
                  f"the plain-Python parser:\n{exc.stderr}", flush=True)
            return None
        except (OSError, subprocess.SubprocessError) as exc:
            _build_failed = True
            print(f"hlax_torch: the native CSV parser is unavailable ({exc}); "
                  "CSV files are read by the plain-Python parser", flush=True)
            return None
        lib.fastcsv_parse.restype = ctypes.c_int
        lib.fastcsv_parse.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native parser built and loaded (building it if needed)."""
    return _load() is not None


def _native(lib: ctypes.CDLL, path: str) -> Optional[np.ndarray]:
    """The native two-pass parse (probe the shape, then fill), or None when
    the parser rejects the file."""
    rows, cols = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = lib.fastcsv_parse(path.encode(), None, ctypes.byref(rows),
                           ctypes.byref(cols))
    if rc != 0 or rows.value <= 0:
        return None
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    rc = lib.fastcsv_parse(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(rows), ctypes.byref(cols))
    return out if rc == 0 else None


def read_csv_matrix(path: str) -> np.ndarray:
    """CSV -> float64 matrix; empty and 'nan' fields -> NaN; a header row is
    skipped.  The native parser when it loaded and accepts the file, else
    the plain-Python one."""
    lib = _load()
    out = _native(lib, str(path)) if lib is not None else None
    if out is not None:
        PARSES["native"] += 1
        return out
    PARSES["fallback"] += 1
    return python_fallback(path)


def python_fallback(path: str) -> np.ndarray:
    """The plain-Python parser (hlax's ``_numpy_fallback``)."""
    rows = []
    with open(path, "r") as f:
        for rec in csv.reader(f):
            try:
                rows.append([float(x) if x not in (None, "") else np.nan
                             for x in rec])
            except ValueError:
                if not rows:
                    continue   # header
                raise
    return np.asarray(rows, dtype=np.float64)
