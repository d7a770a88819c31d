"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc into a shared library of its own with a
plain C interface and loaded with ctypes.  The build happens at first
use, into ``_build/`` beside this file (ignored by git), under a name
keyed by a hash of that source, its headers and the flags, so a fresh
checkout builds once and an edited source rebuilds its own library only.
``library(name)`` holds a lock per library: threads that ask for
different libraries compile side by side, one nvcc each.  Nothing here
runs at import time: the CPU test suite imports every module of the
package on machines without nvcc.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
SOURCE = _CSRC / "gmm_stats_wgmma.cu"         # K1 and K2
# library name → source; "viterbi" is the diarization decoder, "svm_dual"
# the SVM trainer's dual solver
SOURCES = {"gmm_stats": SOURCE, "viterbi": _CSRC / "viterbi.cu",
           "svm_dual": _CSRC / "svm_dual.cu"}
_HEADERS = {"gmm_stats": (_CSRC / "wgmma_ops.cuh",), "viterbi": (),
            "svm_dual": ()}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_locks = {name: threading.Lock() for name in SOURCES}
_seconds_lock = threading.Lock()
_libs: dict = {}
build_seconds: float | None = None     # wall time of this process's builds


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lia_ral_tpu_torch need the CUDA toolkit")
    return found


def _library_path(name: str = "gmm_stats") -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name], *_HEADERS[name]):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{SOURCES[name].stem}_{h.hexdigest()[:16]}.so"


def _compile(source: Path, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(name: str, lib) -> None:
    import ctypes

    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    if name == "gmm_stats":
        lib.lia_stats_scratch_bytes.argtypes = [ll, i, i, i, i, i]
        lib.lia_stats_scratch_bytes.restype = ll
        lib.lia_em_stats_wgmma.argtypes = [p, p, p, p, p, ll, i, i, i, i,
                                           p, p, p]
        lib.lia_em_stats_wgmma.restype = i
        lib.lia_bw_stats_wgmma.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                           p, p, p]
        lib.lia_bw_stats_wgmma.restype = i
    elif name == "viterbi":
        lib.lia_viterbi.argtypes = [p, p, ll, i, f, p, p, p]
        lib.lia_viterbi.restype = i
    else:
        lib.lia_svm_dual.argtypes = [p, p, p, p, i, i, i, p]
        lib.lia_svm_dual.restype = i


def library(name: str = "gmm_stats"):
    """The loaded kernel library ``name`` (a key of ``SOURCES``), built
    on first call."""
    global build_seconds
    with _locks[name]:
        if name in _libs:
            return _libs[name]
        import ctypes

        path = _library_path(name)
        if not path.exists():
            t0 = time.perf_counter()
            _compile(SOURCES[name], path)
            with _seconds_lock:
                build_seconds = ((build_seconds or 0.0)
                                 + time.perf_counter() - t0)
        lib = ctypes.CDLL(str(path))
        _bind(name, lib)
        _libs[name] = lib
        return lib
