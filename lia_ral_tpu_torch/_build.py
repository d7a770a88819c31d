"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes.  The build happens at first use, into
``_build/`` beside this file (ignored by git), under a name keyed by a
hash of the sources and flags, so a fresh checkout builds once and an
edited source rebuilds.  Nothing here runs at import time: the CPU test
suite imports every module of the package on machines without nvcc.
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
SOURCE = _CSRC / "gmm_stats_wgmma.cu"
_HEADERS = (_CSRC / "wgmma_ops.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None     # wall time of this process's build


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


def _library_path() -> Path:
    h = hashlib.sha256()
    for f in (SOURCE, *_HEADERS):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{SOURCE.stem}_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
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


def library():
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        import ctypes

        path = _library_path()
        if not path.exists():
            t0 = time.perf_counter()
            _compile(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lia_stats_scratch_bytes.argtypes = [ll, i, i, i, i, i]
        lib.lia_stats_scratch_bytes.restype = ll
        lib.lia_em_stats_wgmma.argtypes = [p, p, p, p, p, ll, i, i, i, i,
                                           p, p, p]
        lib.lia_em_stats_wgmma.restype = i
        lib.lia_bw_stats_wgmma.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                           p, p, p]
        lib.lia_bw_stats_wgmma.restype = i
        _lib = lib
        return lib
