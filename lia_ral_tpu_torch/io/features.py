"""Feature-file I/O: SPRO3 / SPRO4 / RAW readers and writers + FeatureServer.

Port of ``lia_ral_tpu/io/features.py``: the same readers and writers;
``read_feature_file`` reads through the native ``liaio`` library
(``io/native.py``) first and parses with numpy what it refuses.

Re-provides the capability of the ALIZE FeatureServer / FeatureFileReader
family that every reference tool consumes (SURVEY.md §1.1; usage e.g.
reference ``LIA_SpkTools/src/AccumulateStat.cpp:72-75``).

Formats (reverse-engineered from fixtures + SPro public docs):

* **SPRO3** — header of four little-endian uint32 ``[kind, dim, nframes,
  flag]`` followed by ``nframes × total_dim`` float32, frame-major.
  ``total_dim`` derives from ``dim`` and the qualifier ``flag`` bits
  (E=0x01 energy, Z=0x02 mean-suppressed, N=0x04 static energy suppressed,
  D=0x08 delta, A=0x10 delta-delta).  The in-tree fixture
  ``LIA_SpkDet/TrainWorld/test/test1.prm`` is kind=2 (FBCEPSTRA), dim=16,
  flag=9 (E|D) → 34 floats × 50 frames.
* **SPRO4** — 2-byte uint16 ``dim_total``, 4-byte uint32 qualifier flag,
  4-byte float32 frame rate, then float32 frames.  ``dim_total`` is the
  full stored dimension.
* **RAW** — headerless float32 (or float64) frames; vect size must come
  from config (``loadFeatureFileVectSize``).

``featureServerMask`` ("0-15,17-32") selects columns after load, exactly
like the reference config key (fixture ``TrainWorld.cfg``).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

# SPro qualifier flag bits
WITHE = 0x01  # energy appended
WITHZ = 0x02  # cepstral mean suppressed (no dim effect)
WITHN = 0x04  # static energy suppressed
WITHD = 0x08  # delta block
WITHA = 0x10  # delta-delta block

SPRO3_KINDS = {
    0: "OTHER", 1: "FBANK", 2: "FBCEPSTRA", 3: "LPCEPSTRA",
    4: "LPCOEFF", 5: "PARCOR", 6: "LAR",
}
SPRO3_KIND_IDS = {v: k for k, v in SPRO3_KINDS.items()}


def spro_total_dim(dim: int, flag: int) -> int:
    """Total stored floats per frame for a SPro base dim + qualifier flag."""
    static = dim + (1 if (flag & WITHE and not flag & WITHN) else 0)
    block = dim + (1 if flag & WITHE else 0)
    total = static
    if flag & WITHD:
        total += block
    if flag & WITHA:
        total += block
    return total


@dataclasses.dataclass
class FeatureFile:
    """A loaded feature matrix plus its source metadata."""

    data: np.ndarray          # (nframes, dim) float32
    rate: float = 100.0       # frames per second
    kind: str = "FBCEPSTRA"
    flag: int = 0

    @property
    def nframes(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]


def _read_spro3(raw: bytes, big_endian: bool) -> FeatureFile:
    bo = ">" if big_endian else "<"
    kind, dim, nframes, flag = struct.unpack(bo + "4I", raw[:16])
    total = spro_total_dim(dim, flag)
    payload = np.frombuffer(raw, dtype=bo + "f4", offset=16)
    if nframes * total != payload.size:
        # header nframes can disagree; trust the payload size
        if payload.size % total == 0:
            nframes = payload.size // total
        else:
            raise ValueError(
                f"SPRO3 payload {payload.size} not divisible by total dim {total}"
            )
    data = payload[: nframes * total].reshape(nframes, total)
    return FeatureFile(np.ascontiguousarray(data, dtype=np.float32),
                       kind=SPRO3_KINDS.get(kind, "OTHER"), flag=flag)


def _read_spro4(raw: bytes, big_endian: bool) -> FeatureFile:
    bo = ">" if big_endian else "<"
    off = 0
    # SPro 4 optional variable header ends with "</header>\n"
    if raw[:8] == b"<header>":
        end = raw.index(b"</header>") + len(b"</header>")
        if end < len(raw) and raw[end] == 0x0A:
            end += 1
        off = end
    dim, = struct.unpack_from(bo + "H", raw, off)
    flag, = struct.unpack_from(bo + "I", raw, off + 2)
    rate, = struct.unpack_from(bo + "f", raw, off + 6)
    payload = np.frombuffer(raw, dtype=bo + "f4", offset=off + 10)
    if dim == 0 or payload.size % dim != 0:
        raise ValueError(f"SPRO4 dim {dim} does not divide payload {payload.size}")
    data = payload.reshape(-1, dim)
    return FeatureFile(np.ascontiguousarray(data, dtype=np.float32),
                       rate=float(rate), flag=flag)


def _read_raw(raw: bytes, vect_size: int, big_endian: bool,
              dtype: str = "f4") -> FeatureFile:
    bo = ">" if big_endian else "<"
    payload = np.frombuffer(raw, dtype=bo + dtype)
    if vect_size <= 0 or payload.size % vect_size != 0:
        raise ValueError(f"RAW vectSize {vect_size} does not divide {payload.size}")
    return FeatureFile(
        np.ascontiguousarray(payload.reshape(-1, vect_size), dtype=np.float32))


def _read_htk(raw: bytes) -> FeatureFile:
    """HTK parameter file (always big-endian): 12-byte header
    [nSamples:u32][sampPeriod:u32, 100 ns][sampSize:u16, bytes]
    [parmKind:u16] then f32 samples (HTK Book §5.10; ALIZE
    loadFeatureFileFormat HTK)."""
    n, period, samp_size, parm_kind = struct.unpack_from(">IIHH", raw, 0)
    dim = samp_size // 4
    if dim == 0 or len(raw) < 12 + n * samp_size:
        raise ValueError(f"HTK header implies {n}x{dim} beyond file size")
    data = np.frombuffer(raw, ">f4", count=n * dim, offset=12).reshape(n, dim)
    rate = 1e7 / period if period else 100.0
    return FeatureFile(np.ascontiguousarray(data, dtype=np.float32),
                       rate=float(rate), flag=parm_kind)


def _spro_meta(path: str, fmt: str, big_endian: bool
               ) -> tuple[float, str, int]:
    """(rate, kind, flag) from a SPRO3/SPRO4 header, as the numpy readers
    return them (a RAW file has none: the defaults)."""
    bo = ">" if big_endian else "<"
    if fmt == "RAW":
        return 100.0, "FBCEPSTRA", 0
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    if fmt == "SPRO3":
        kind, _, _, flag = struct.unpack_from(bo + "4I", head)
        return 100.0, SPRO3_KINDS.get(kind, "OTHER"), flag
    off = 0
    if head[:8] == b"<header>":
        off = head.index(b"</header>") + len(b"</header>")
        if off < len(head) and head[off] == 0x0A:
            off += 1
    flag, rate = struct.unpack_from(bo + "If", head, off + 2)
    return float(rate), "FBCEPSTRA", flag


def read_feature_file(
    path: str,
    fmt: str = "SPRO4",
    big_endian: bool = False,
    vect_size: int = 0,
    use_native: bool = True,
) -> FeatureFile:
    """Read one feature file.  ``fmt`` ∈ {SPRO3, SPRO4, RAW, HTK}.

    The reference's own fixtures are labelled inconsistently (TrainWorld.cfg
    declares SPRO4 for a SPRO3-headered file), so SPRO3/SPRO4 fall back to
    each other when the declared parse fails.

    The payload goes through the native liaio library first (the
    reference's runtime is native C++; see native/liaio.cpp); HTK and
    whatever the native reader refuses are parsed with numpy.  The two
    give the same arrays; ``io.native.read_counts`` counts each path.
    """
    from .native import count_read, read_features_native

    fmt_u = fmt.upper()
    if fmt_u != "HTK" and use_native:
        order = ([fmt_u] if fmt_u == "RAW"
                 else (["SPRO3", "SPRO4"] if fmt_u == "SPRO3"
                       else ["SPRO4", "SPRO3"]))
        for f_try in order:
            data = read_features_native(path, f_try, big_endian, vect_size)
            if data is not None:
                return FeatureFile(data, *_spro_meta(path, f_try,
                                                     big_endian))
    ff = _read_numpy(path, fmt_u, big_endian, vect_size)
    count_read("numpy")
    return ff


def _read_numpy(path: str, fmt: str, big_endian: bool, vect_size: int
                ) -> FeatureFile:
    """The numpy readers of ``read_feature_file``."""
    with open(path, "rb") as f:
        raw = f.read()
    if fmt == "HTK":
        return _read_htk(raw)
    if fmt == "RAW":
        return _read_raw(raw, vect_size, big_endian)
    readers = ([_read_spro3, _read_spro4] if fmt == "SPRO3"
               else [_read_spro4, _read_spro3])
    last_err: Exception | None = None
    for rd in readers:
        try:
            return rd(raw, big_endian)
        except (ValueError, struct.error, IndexError) as e:
            last_err = e
    raise ValueError(f"cannot parse {path} as {fmt}: {last_err}")


def write_feature_file(
    path: str,
    data: np.ndarray,
    fmt: str = "SPRO4",
    big_endian: bool = False,
    rate: float = 100.0,
    kind: str = "FBCEPSTRA",
    flag: int = 0,
) -> None:
    data = np.asarray(data, dtype=np.float32)
    bo = ">" if big_endian else "<"
    fmt = fmt.upper()
    with open(path, "wb") as f:
        if fmt == "SPRO3":
            # store with flag=0: header dim is the full stored dim
            f.write(struct.pack(bo + "4I", SPRO3_KIND_IDS.get(kind, 0),
                                data.shape[1], data.shape[0], 0))
        elif fmt == "SPRO4":
            f.write(struct.pack(bo + "H", data.shape[1]))
            f.write(struct.pack(bo + "I", flag))
            f.write(struct.pack(bo + "f", rate))
        elif fmt == "HTK":
            # HTK is always big-endian (header + samples)
            period = int(round(1e7 / rate)) if rate else 100000
            f.write(struct.pack(">IIHH", data.shape[0], period,
                                data.shape[1] * 4, flag or 9))  # 9 = USER
            f.write(data.astype(">f4").tobytes())
            return
        elif fmt != "RAW":
            raise ValueError(f"unknown feature format {fmt}")
        f.write(data.astype(bo + "f4").tobytes())


# -- featureServerMask --------------------------------------------------------

def parse_mask(mask: str) -> list[int]:
    """Parse "0-15,17-32" → [0,...,15,17,...,32] (reference featureServerMask)."""
    out: list[int] = []
    for part in mask.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def apply_mask(data: np.ndarray, mask: str | list[int] | None) -> np.ndarray:
    if mask is None:
        return data
    idx = parse_mask(mask) if isinstance(mask, str) else mask
    return np.ascontiguousarray(data[:, idx])


class FeatureServer:
    """Multi-file frame store with per-source index bookkeeping.

    Equivalent of the ALIZE FeatureServer as consumed by the reference
    (``seekFeature``/``getFirstFeatureIndexOfASource``): concatenates the
    frames of an ordered list of files and knows each source's start index.
    All frames are materialised as one (N, D) float32 array — device
    batching happens downstream.
    """

    def __init__(
        self,
        paths: list[str],
        fmt: str = "SPRO4",
        mask: str | None = None,
        big_endian: bool = False,
        vect_size: int = 0,
    ) -> None:
        self.paths = list(paths)
        mats, starts, n = [], [], 0
        for p in self.paths:
            ff = read_feature_file(p, fmt=fmt, big_endian=big_endian,
                                   vect_size=vect_size)
            m = apply_mask(ff.data, mask)
            starts.append(n)
            n += m.shape[0]
            mats.append(m)
        self.data = (np.concatenate(mats, axis=0) if mats
                     else np.zeros((0, 0), np.float32))
        self.starts = np.asarray(starts + [n], dtype=np.int64)

    @property
    def nframes(self) -> int:
        return int(self.starts[-1])

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    def source_range(self, i: int) -> tuple[int, int]:
        return int(self.starts[i]), int(self.starts[i + 1])

    def source_frames(self, i: int) -> np.ndarray:
        a, b = self.source_range(i)
        return self.data[a:b]


def feature_path(name: str, cfg) -> str:
    """Resolve a feature file path from config keys (reference convention:
    featureFilesPath + name + loadFeatureFileExtension)."""
    root = cfg.get_str("featureFilesPath", "./")
    ext = cfg.get_str("loadFeatureFileExtension", ".prm")
    return os.path.join(root, name + ext)


def server_from_config(names: list[str], cfg) -> FeatureServer:
    return FeatureServer(
        [feature_path(n, cfg) for n in names],
        fmt=cfg.get_str("loadFeatureFileFormat", "SPRO4"),
        mask=cfg.get_str("featureServerMask") if cfg.exists("featureServerMask") else None,
        big_endian=cfg.get_bool("bigEndian", False),
        vect_size=cfg.get_int("loadFeatureFileVectSize", 0),
    )
