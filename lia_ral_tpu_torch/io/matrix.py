"""Matrix (.matx) I/O: ALIZE-compatible text (DT) and binary (DB) formats.

A copy of ``lia_ral_tpu/io/matrix.py`` (numpy only): the port may not
import the JAX package, whose ``__init__`` imports jax.

Capability parity with ALIZE ``Matrix<double>::load/save`` used throughout
the reference factor-analysis stack (e.g. T-matrix save in
``LIA_SpkDet/TotalVariability/TotalVariability.cpp:155-168``).

* **DT (text)** — first line "rows cols", then rows of space-separated
  values (fixture ``LIA_SpkDet/ComputeTest/test/zero.mat``).
* **DB (binary)** — little-endian ``[rows:u32][cols:u32]`` + f64 data,
  row-major (fixture ``LIA_Utils/NAPSV/test/M9314.vect``).
"""

from __future__ import annotations

import struct

import numpy as np


def write_matrix_file(path: str, mat: np.ndarray, fmt: str = "DB") -> None:
    mat = np.atleast_2d(np.asarray(mat, dtype=np.float64))
    fmt = fmt.upper()
    if fmt == "DB":
        with open(path, "wb") as f:
            f.write(struct.pack("<2I", mat.shape[0], mat.shape[1]))
            f.write(mat.astype("<f8").tobytes())
    elif fmt == "DT":
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{mat.shape[0]} {mat.shape[1]}\n")
            for row in mat:
                f.write(" ".join(f"{v:.17g}" for v in row) + " \n")
    else:
        raise ValueError(f"unknown matrix format {fmt}")


def read_matrix_file(path: str, fmt: str | None = None) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    # auto-detect: text files begin with ascii digits + space + digits + \n
    head = raw[:64].split(b"\n", 1)[0]
    looks_text = False
    try:
        parts = head.decode("ascii").split()
        looks_text = len(parts) == 2 and all(p.isdigit() for p in parts)
    except UnicodeDecodeError:
        pass
    if fmt is not None:
        looks_text = fmt.upper() == "DT"
    if looks_text:
        lines = raw.decode("ascii", errors="replace").splitlines()
        rows, cols = (int(x) for x in lines[0].split())
        data = np.fromiter((float(t) for ln in lines[1:] for t in ln.split()),
                           dtype=np.float64)
        if data.size != rows * cols:
            raise ValueError(f"DT matrix: got {data.size} values, "
                             f"expected {rows}x{cols}")
        return data.reshape(rows, cols)
    rows, cols = struct.unpack_from("<2I", raw, 0)
    expected = 8 + rows * cols * 8
    if len(raw) != expected:
        raise ValueError(f"DB matrix size {len(raw)} != expected {expected} "
                         f"({rows}x{cols}; possibly CRLF-corrupted fixture)")
    return np.frombuffer(raw, "<f8", offset=8).reshape(rows, cols).copy()
