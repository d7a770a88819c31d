"""Diagonal-GMM model file I/O: ALIZE-compatible XML and RAW formats.

A copy of ``lia_ral_tpu/io/gmm_io.py`` (numpy only): the port may not
import the JAX package, whose ``__init__`` imports jax.

Capability parity with ALIZE MixtureGD load/save as used by the reference
(e.g. ``LIA_SpkDet/TrainWorld/TrainWorld.cpp:170-183``; config keys
``saveMixtureFileFormat RAW|XML``).

Formats (reverse-engineered from in-tree fixtures):

* **XML** — ``<MixtureGD version="1" id=".." distribCount="K" vectSize="D">``
  with per-distrib ``<DistribGD i weight cst det>`` holding ``<covInv i>``
  and ``<mean i>`` elements (fixture ``TrainWorld/test/wld.validate``).
* **RAW** — little-endian ``[K:u32][D:u32][weights: K×f64]`` then per
  distrib ``[cst:f64][det:f64][flag:u8][covInv: D×f64][mean: D×f64]``
  (fixture ``TrainTarget/test/wld``; note several in-tree RAW fixtures are
  corrupted by historical CRLF→LF conversion and are 1-3 bytes short).

The in-memory representation here is plain numpy arrays
``(weights[K], means[K,D], cov_inv[K,D])`` — the GmmDiag pytree in
``lia_ral_tpu.gmm.model`` is constructed from these.
"""

from __future__ import annotations

import math
import re
import struct

import numpy as np

_LOG_2PI = math.log(2.0 * math.pi)


def gmm_cst_det(cov_inv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ALIZE DistribGD derived terms: det = ∏ 1/covInv (determinant of the
    covariance), cst = 1/((2π)^{D/2}·sqrt(det))."""
    cov_inv = np.asarray(cov_inv, dtype=np.float64)
    d = cov_inv.shape[-1]
    log_det = -np.sum(np.log(cov_inv), axis=-1)
    det = np.exp(log_det)
    cst = np.exp(-0.5 * (d * _LOG_2PI + log_det))
    return cst, det


def write_gmm_file(
    path: str,
    weights: np.ndarray,
    means: np.ndarray,
    cov_inv: np.ndarray,
    fmt: str = "RAW",
    model_id: str = "#1",
) -> None:
    weights = np.asarray(weights, dtype=np.float64)
    means = np.asarray(means, dtype=np.float64)
    cov_inv = np.asarray(cov_inv, dtype=np.float64)
    k, d = means.shape
    cst, det = gmm_cst_det(cov_inv)
    fmt = fmt.upper()
    if fmt == "RAW":
        with open(path, "wb") as f:
            f.write(struct.pack("<2I", k, d))
            f.write(weights.astype("<f8").tobytes())
            for i in range(k):
                f.write(struct.pack("<2d", cst[i], det[i]))
                f.write(b"\x00")
                f.write(cov_inv[i].astype("<f8").tobytes())
                f.write(means[i].astype("<f8").tobytes())
    elif fmt == "XML":
        with open(path, "w", encoding="utf-8") as f:
            f.write(f'<MixtureGD version="1" id="{model_id}" '
                    f'distribCount="{k}" vectSize="{d}">\n')
            for i in range(k):
                f.write(f'\t<DistribGD i="{i}" weight="{weights[i]:.19g}" '
                        f'cst="{cst[i]:.19g}" det="{det[i]:.19g}">\n')
                for j in range(d):
                    f.write(f'\t\t<covInv i="{j}">{cov_inv[i, j]:.19g}</covInv>\n')
                for j in range(d):
                    f.write(f'\t\t<mean i="{j}">{means[i, j]:.19g}</mean>\n')
                f.write("\t</DistribGD>\n")
            f.write("</MixtureGD>\n")
    else:
        raise ValueError(f"unknown mixture format {fmt}")


def _read_gmm_raw(raw: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    k, d = struct.unpack_from("<2I", raw, 0)
    off = 8
    weights = np.frombuffer(raw, "<f8", count=k, offset=off).copy()
    off += 8 * k
    means = np.empty((k, d), np.float64)
    cov_inv = np.empty((k, d), np.float64)
    rec = 17 + 16 * d
    expected = off + k * rec
    if len(raw) != expected:
        raise ValueError(
            f"RAW mixture size {len(raw)} != expected {expected} "
            f"(K={k}, D={d}; possibly CRLF-corrupted fixture)")
    for i in range(k):
        cov_inv[i] = np.frombuffer(raw, "<f8", count=d, offset=off + 17)
        means[i] = np.frombuffer(raw, "<f8", count=d, offset=off + 17 + 8 * d)
        off += rec
    return weights, means, cov_inv


_XML_DISTRIB = re.compile(
    r'<DistribGD\s+i="(\d+)"\s+weight="([^"]+)"[^>]*>(.*?)</DistribGD>',
    re.S)
_XML_COVINV = re.compile(r'<covInv\s+i="(\d+)">([^<]+)</covInv>')
_XML_MEAN = re.compile(r'<mean\s+i="(\d+)">([^<]+)</mean>')


def _read_gmm_xml(text: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    head = re.search(r'<MixtureGD[^>]*distribCount="(\d+)"\s+vectSize="(\d+)"',
                     text)
    if not head:
        raise ValueError("not a MixtureGD XML file")
    k, d = int(head.group(1)), int(head.group(2))
    weights = np.zeros(k, np.float64)
    means = np.zeros((k, d), np.float64)
    cov_inv = np.zeros((k, d), np.float64)
    for m in _XML_DISTRIB.finditer(text):
        i = int(m.group(1))
        weights[i] = float(m.group(2))
        body = m.group(3)
        for cm in _XML_COVINV.finditer(body):
            cov_inv[i, int(cm.group(1))] = float(cm.group(2))
        for mm in _XML_MEAN.finditer(body):
            means[i, int(mm.group(1))] = float(mm.group(2))
    return weights, means, cov_inv


def read_gmm_file(
    path: str, fmt: str | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a mixture file → (weights[K], means[K,D], cov_inv[K,D]).

    ``fmt`` None auto-detects (XML files start with '<MixtureGD')."""
    with open(path, "rb") as f:
        raw = f.read()
    is_xml = raw.lstrip()[:10].startswith(b"<MixtureGD")
    if fmt is not None:
        fmt = fmt.upper()
        if fmt == "XML" or (fmt != "RAW" and is_xml):
            is_xml = True
        elif fmt == "RAW":
            is_xml = is_xml  # trust content over label (fixtures mislabel)
    if is_xml:
        return _read_gmm_xml(raw.decode("utf-8", errors="replace"))
    return _read_gmm_raw(raw)
