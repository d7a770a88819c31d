"""ctypes bindings of the native liaio feature reader (port of
lia_ral_tpu/io/native.py).

``native/liaio.cpp`` parses SPRO3/SPRO4/RAW files and masks columns in
C++, and reads a batch of files with a pool of threads; it is the
native hot path of the reference's FeatureServer.  The port builds it
with g++ at first use into its own build directory (``_build.host_build``:
the Makefile's flags, never into ``native/``) and raises with the
compiler's output if the build fails.  A file the native reader refuses
(HTK, a SPRO3 file declared SPRO4, a bad header) goes to the numpy reader
of ``io/features.py``, as in the JAX package; ``read_counts`` counts the
files each path read, so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_FMT_IDS = {"SPRO3": 0, "SPRO4": 1, "RAW": 2, "RAW64": 3}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# files read by each path, counted where the read succeeds
read_counts = {"native": 0, "numpy": 0}


def reset_read_counts() -> None:
    for k in read_counts:
        read_counts[k] = 0


def count_read(path: str, n: int = 1) -> None:
    with _lock:
        read_counts[path] += n


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
    from .._build import host_build

    lib = ctypes.CDLL(str(host_build("liaio")))
    lib.liaio_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    lib.liaio_probe.restype = ctypes.c_int
    lib.liaio_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int]
    lib.liaio_read.restype = ctypes.c_int
    lib.liaio_mask.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.liaio_mask.restype = None
    lib.liaio_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int]
    lib.liaio_read_batch.restype = ctypes.c_int
    with _lock:
        _lib = _lib or lib
        return _lib


def available() -> bool:
    """The library builds and loads (a failed build raises)."""
    return _load() is not None


def read_features_native(path: str, fmt: str, big_endian: bool = False,
                         vect_size: int = 0) -> np.ndarray | None:
    """Native read → (frames, dim) float32, or None where the native
    reader refuses the file or the format (the caller reads it with
    numpy)."""
    if fmt.upper() not in _FMT_IDS:
        return None
    lib = _load()
    fid = _FMT_IDS[fmt.upper()]
    frames = ctypes.c_int64()
    dim = ctypes.c_int()
    rc = lib.liaio_probe(path.encode(), fid, int(big_endian), vect_size,
                         ctypes.byref(frames), ctypes.byref(dim))
    if rc != 0:
        return None
    out = np.empty((frames.value, dim.value), np.float32)
    rc = lib.liaio_read(path.encode(), fid, int(big_endian), vect_size,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        frames.value, dim.value)
    if rc != 0:
        return None
    count_read("native")
    return out


def apply_mask_native(data: np.ndarray, idx: list[int]) -> np.ndarray:
    """The columns ``idx`` of ``data``, gathered natively."""
    lib = _load()
    data = np.ascontiguousarray(data, np.float32)
    idx_arr = np.asarray(idx, np.int32)
    out = np.empty((data.shape[0], idx_arr.size), np.float32)
    lib.liaio_mask(data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   data.shape[0], data.shape[1],
                   idx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                   idx_arr.size,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def read_features_batch_native(paths: list[str], fmt: str,
                               big_endian: bool = False, vect_size: int = 0,
                               n_threads: int = 0
                               ) -> "list[np.ndarray | None] | None":
    """Parallel native batch read (liaio_read_batch's worker pool over an
    atomic file index — the native data-loader face of the reference's
    per-thread file-list split, AccumulateTVStat.cpp:478-551).

    Returns per-file (frames, dim) float32 arrays in input order, None
    entries for unreadable/mismatched files, or None overall where no file
    probes in the declared format or its SPRO sibling (the caller reads
    those with numpy).  All files must share the first readable file's
    dim (the framework's batch contract)."""
    if fmt.upper() not in _FMT_IDS or not paths:
        return None
    lib = _load()
    # the reference's own fixtures mislabel SPRO3/SPRO4 (TrainWorld.cfg
    # declares SPRO4 for SPRO3-headered files) — mirror the per-file
    # reader's header sniffing: if the declared format probes nothing,
    # try the sibling SPRO format for the whole batch
    orders = {"SPRO4": ["SPRO4", "SPRO3"], "SPRO3": ["SPRO3", "SPRO4"]}
    frames = ctypes.c_int64()
    dim_c = ctypes.c_int()
    fid = dim = 0
    for f_try in orders.get(fmt.upper(), [fmt.upper()]):
        fid = _FMT_IDS[f_try]
        for p in paths:
            if lib.liaio_probe(p.encode(), fid, int(big_endian),
                               vect_size, ctypes.byref(frames),
                               ctypes.byref(dim_c)) == 0:
                dim = dim_c.value
                break
        if dim > 0:
            break
    if dim <= 0:
        return None
    sizes = []
    for p in paths:
        try:
            sizes.append(os.path.getsize(p))
        except OSError:
            sizes.append(0)
    t_pad = max(1, max(sizes) // (dim * 4) + 1)
    arena = np.zeros((len(paths), t_pad, dim), np.float32)
    lengths = np.full(len(paths), -1, np.int64)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    lib.liaio_read_batch(
        c_paths, len(paths), fid, int(big_endian), vect_size,
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t_pad, dim, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads)
    # .copy(): a view would pin the whole (n, t_pad, dim) arena (sized by
    # the LARGEST file of the batch) for the lifetime of every small
    # file's array
    out = [arena[i, :int(lengths[i])].copy() if lengths[i] >= 0 else None
           for i in range(len(paths))]
    count_read("native", sum(o is not None for o in out))
    return out
