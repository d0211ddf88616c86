"""Build and load the port's CUDA kernels (``hlax_torch/csrc/*.cu``).

Each ``<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/lib<name>.so`` at the repository
root, on first use, and loaded with ``ctypes``.  A library newer than its
sources and built with the same flags (``lib<name>.flags`` beside it) is
reused.  ``build_all`` starts one ``nvcc`` per source at once.
Nothing here runs at import: the CPU tests import every module, and there is
no ``nvcc`` without the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Libraries built with contraction of a*b+c into one fused multiply-add.
# The mid kernel's blocked path, the two backward kernels and the fused
# step ops (``fusion``) sum in another order than their plain versions
# (blocked panels; register subtiles; a row at a time) and are held to a
# float64 reference; the backwards' five products are chains of
# multiply-adds, which fusing halves.  The small kernel's library is built
# with --fmad=false: its shared-memory path (n > 32) then does the same
# float32 operations as its plain PyTorch version and the two agree to the
# last bit.  The one-warp body both forward libraries share spells its
# roundings out (__fmul_rn, __fsub_rn), so it is bit-equal under either flag.
# The bound's kernels (``gp_bound``) and the natural-gradient chain's
# (``natgrad``) sum in other orders than their plain versions (tiles,
# butterflies, double partials, row strips) and are held to them within a
# float64 reference's bars: contracted too.
FMA_CONTRACTED = frozenset({"chol_inv_mid", "chol_inv_bwd",
                            "chol_inv_mid_bwd", "fusion", "gp_bound",
                            "natgrad"})

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def nvcc_flags(name: str) -> List[str]:
    return NVCC_FLAGS + ([] if name in FMA_CONTRACTED else ["--fmad=false"])


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _flags_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.flags"


def _stale(name: str) -> bool:
    lib, stamp = _lib_path(name), _flags_path(name)
    if not lib.is_file() or not stamp.is_file():
        return True
    if stamp.read_text() != " ".join(nvcc_flags(name)):
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every stale library among ``names`` concurrently.  Returns the
    compiler's output (ptxas register and shared-memory report) by name;
    raises with that output when a build fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [nvcc, *nvcc_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, _lib_path(n))
            _flags_path(n).write_text(" ".join(nvcc_flags(n)))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``lib<name>.so``, built first if needed.
    Its C entries take pointers and the stream as ``void*`` and return the
    launch's ``cudaGetLastError()``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, what: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
