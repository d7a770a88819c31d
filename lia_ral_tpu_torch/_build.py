"""Build and load the hand-written CUDA kernels (csrc/*.cu), and build
the repo's native C++ sources (native/*.cpp) that the port uses.

Each source is compiled with nvcc into a shared library of its own with a
plain C interface and loaded with ctypes.  The build happens at first
use, into ``_build/`` beside this file (ignored by git), under a name
keyed by a hash of that source, its headers and the flags, so a fresh
checkout builds once and an edited source rebuilds its own library only.
``library(name)`` holds a lock per library: threads that ask for
different libraries compile side by side, one nvcc each.  Nothing here
runs at import time: the CPU test suite imports every module of the
package on machines without nvcc.

``host_build(name)`` compiles ``native/<name>.cpp`` with g++ and the
flags of ``native/Makefile`` into the same directory (never into
``native/``): the feature reader ``liaio`` as a shared library
(``io/native.py``), the f64 parity oracle as a program
(``scripts/torch_oracle_parity.py``).  A failed build raises with the
compiler's output.
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
# library name → source: "gmm_stats" holds K1/K2 in the four tiers (what
# config keys and tools reach), "gmm_stats_modes" every arithmetic of the
# JAX wrappers (the same source, whole); "viterbi" is the diarization
# decoder, "svm_dual" the SVM trainer's dual solver
SOURCES = {"gmm_stats": SOURCE, "gmm_stats_modes": SOURCE,
           "viterbi": _CSRC / "viterbi.cu", "svm_dual": _CSRC / "svm_dual.cu"}
_HEADERS = {"gmm_stats": (_CSRC / "wgmma_ops.cuh",),
            "gmm_stats_modes": (_CSRC / "wgmma_ops.cuh",), "viterbi": (),
            "svm_dual": ()}
# each library's own defines: the tiers' build leaves the other modes'
# kernel instances out, so the main paths build in a fraction of the time
DEFINES = {"gmm_stats": ("-DLIA_TIERS_ONLY",)}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_flags(name: str) -> tuple[str, ...]:
    """nvcc's flags for library ``name``."""
    return NVCC_FLAGS + DEFINES.get(name, ())

# native/Makefile's own flags: line 2 for the library, lines 21-22 for
# the oracle (no -ffast-math: it is the careful f64 side of a parity run)
NATIVE_DIR = _PKG.parent / "native"
GXX_FLAGS = {"liaio": ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"),
             "oracle": ("-O3", "-march=native", "-std=c++17", "-Wall")}
GXX_LIBS = {"liaio": (), "oracle": ("-lpthread",)}

_locks = {name: threading.Lock() for name in (*SOURCES, *GXX_FLAGS)}
_libs: dict = {}
build_times: dict = {}      # library name → seconds of its build here


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
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{SOURCES[name].stem}_{h.hexdigest()[:16]}.so"


def _compile(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *nvcc_flags(name), "-o", tmp, str(SOURCES[name])]
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

    p, i, ll, f, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float, ctypes.c_ulonglong)
    if name in ("gmm_stats", "gmm_stats_modes"):
        # the mode: logit passes, exp mode, stats form, nx, seed
        mode = [i, i, i, i, u64]
        lib.lia_stats_scratch_bytes.argtypes = [ll, i, i, i, i, i, i, i]
        lib.lia_stats_scratch_bytes.restype = ll
        lib.lia_em_stats_wgmma.argtypes = [p, p, p, p, p, ll, i, i, i,
                                           *mode, p, p, p]
        lib.lia_em_stats_wgmma.restype = i
        lib.lia_bw_stats_wgmma.argtypes = [p, p, p, p, p, i, i, i, i,
                                           *mode, p, p, p]
        lib.lia_bw_stats_wgmma.restype = i
        # the grouped K1: frames, weights, the bank; n_frames, D, K, S,
        # chunk_len, n_chunks; table, scratch, out, stream
        lib.lia_stats_grouped_scratch_bytes.argtypes = [ll, i, i, i, i, i]
        lib.lia_stats_grouped_scratch_bytes.restype = ll
        lib.lia_em_stats_grouped_wgmma.argtypes = [p, p, p, p, p, ll, i, i,
                                                   i, i, i, p, p, p, p]
        lib.lia_em_stats_grouped_wgmma.restype = i
    elif name == "viterbi":
        # em, lt, N, S, log S; deltas, back pointer, unit map and tail
        # scratch; path; the stream
        lib.lia_viterbi.argtypes = [p, p, ll, i, f, p, p, p, p, p, p]
        lib.lia_viterbi.restype = i
        lib.lia_viterbi_shared_bytes.argtypes = [i]
        lib.lia_viterbi_shared_bytes.restype = i
    else:
        # k, y, c, alpha, Q scratch; B, N, n_iter; the plan: cluster,
        # threads, rows, tile, resident; the stream
        lib.lia_svm_dual.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                     p]
        lib.lia_svm_dual.restype = i
        lib.lia_svm_max_cluster.argtypes = [i]
        lib.lia_svm_max_cluster.restype = i
        lib.lia_svm_shared_bytes.argtypes = [i, i, i, i]
        lib.lia_svm_shared_bytes.restype = ll
        lib.lia_svm_shared_limit.argtypes = []
        lib.lia_svm_shared_limit.restype = i


def library(name: str = "gmm_stats"):
    """The loaded kernel library ``name`` (a key of ``SOURCES``), built
    on first call."""
    with _locks[name]:
        if name in _libs:
            return _libs[name]
        import ctypes

        path = _library_path(name)
        if not path.exists():
            t0 = time.perf_counter()
            _compile(name, path)
            build_times[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        _bind(name, lib)
        _libs[name] = lib
        return lib


def _host_key() -> bytes:
    """The build host's CPU flags: a -march=native program is keyed by
    them, so a copy of the build directory on another machine rebuilds."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")),
                        "").encode()
    except OSError:
        return b""


def host_build(name: str) -> Path:
    """``native/<name>.cpp`` built by g++ (``GXX_FLAGS``) into
    ``BUILD_DIR``, once per source, flags and host; returns its path."""
    src = NATIVE_DIR / f"{name}.cpp"
    flags = GXX_FLAGS[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    if "-march=native" in flags:
        h.update(_host_key())
    shared = "-shared" in flags
    out = BUILD_DIR / (f"lib{name}_{h.hexdigest()[:16]}.so" if shared
                       else f"{name}_{h.hexdigest()[:16]}")
    with _locks[name]:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR)
        os.close(fd)
        cmd = [os.environ.get("CXX", "g++"), *flags, "-o", tmp, str(src),
               *GXX_LIBS[name]]
        try:
            try:
                proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
            except OSError as e:
                raise RuntimeError(f"cannot run {cmd[0]} to build {src}: "
                                   f"{e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}")
            os.chmod(tmp, 0o755)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out
