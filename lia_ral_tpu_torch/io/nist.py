"""Score-file I/O: NIST and LIA_RAL result-line formats.

A copy of ``lia_ral_tpu/io/nist.py`` (numpy only): the port may not
import the JAX package, whose ``__init__`` imports jax.

Capability parity with reference ``LIA_SpkTools/src/IOFormat.cpp``
(``outputResultLine`` NIST format "gender model decision seg score",
fixture ``LIA_Utils/Scoring/test/score.nist``: "F model1 - test1 0";
segmental variant adds begin/end seconds, fixture
``LIA_SpkDet/ComputeTest/test/test1.validate.res``:
"M test1 1 test3 0 0.26 5.06601").
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ScoreLine:
    gender: str
    model: str
    decision: str          # "1"/"0" or "-"
    seg: str
    score: float
    begin: float | None = None   # segmental mode only
    end: float | None = None

    def format(self) -> str:
        if self.begin is not None:
            return (f"{self.gender} {self.model} {self.decision} {self.seg} "
                    f"{_fmt(self.begin)} {_fmt(self.end)} {_fmt(self.score)}")
        return (f"{self.gender} {self.model} {self.decision} {self.seg} "
                f"{_fmt(self.score)}")


def _fmt(v: float | None) -> str:
    if v is None:
        return ""
    txt = f"{v:g}"
    return txt


def parse_score_line(line: str) -> ScoreLine | None:
    p = line.split()
    if len(p) == 5:
        return ScoreLine(p[0], p[1], p[2], p[3], float(p[4]))
    if len(p) == 7:
        return ScoreLine(p[0], p[1], p[2], p[3], float(p[6]),
                         begin=float(p[4]), end=float(p[5]))
    return None


def read_nist_scores(path: str) -> list[ScoreLine]:
    out: list[ScoreLine] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            sl = parse_score_line(line)
            if sl is not None:
                out.append(sl)
    return out


def write_nist_scores(path: str, lines: list[ScoreLine]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for sl in lines:
            f.write(sl.format() + "\n")


# ---------------------------------------------------------------------------
# Additional reference result-line formats (IOFormat.cpp:124-148)
# ---------------------------------------------------------------------------

def format_liaral_line(gender: str, client: str, channel: str, seg: str,
                       start: str, duration: str, llr: float) -> str:
    """outputResultLIARALLine (IOFormat.cpp:124): 'gender client channel
    seg start duration LLR'."""
    return f"{gender} {client} {channel} {seg} {start} {duration} {_fmt(llr)}"


def format_nist04_line(train_type: str, adaptation: str, seg_type: str,
                       gender: str, client: str, seg: str, decision: str,
                       llr: float) -> str:
    """outputResultNIST04Line (IOFormat.cpp:131): NIST SRE 2004 8-field
    line."""
    return (f"{train_type} {adaptation} {seg_type} {gender} {client} "
            f"{seg} {decision} {_fmt(llr)}")


def format_etf_line(source: str, channel: str, start: str, duration: float,
                    typ: str, sub: str, event: str, score: float,
                    decision: str) -> str:
    """outputResultETFLine (IOFormat.cpp:138)."""
    return (f"{source} {channel} {start} {_fmt(duration)} {typ} {sub} "
            f"{event} {_fmt(score)} {decision}")


def format_mdtm_line(source: str, channel: str, start: str, duration: float,
                     typ: str, conf: float, sub: str) -> str:
    """outputResultMDTMLine (IOFormat.cpp:145): diarization MDTM line."""
    return f"{source} {channel} {start} {_fmt(duration)} {typ} {_fmt(conf)} {sub}"


def write_svmlight_vector(path: str, vector, label: int = 1) -> None:
    """outputSVMLightVector (IOFormat.h:81): 'label 1:v1 2:v2 ...' sparse
    SVMLight line (1-based feature ids)."""
    parts = [str(label)]
    parts += [f"{i + 1}:{float(v):g}" for i, v in enumerate(vector)]
    with open(path, "w", encoding="utf-8") as f:
        f.write(" ".join(parts) + "\n")


def read_svmlight_vector(path: str):
    """Inverse of write_svmlight_vector — returns (label, np.ndarray)."""
    import numpy as np
    with open(path, "r", encoding="utf-8") as f:
        parts = f.read().split()
    label = int(float(parts[0]))
    idx_val = [p.split(":") for p in parts[1:]]
    n = max(int(i) for i, _ in idx_val) if idx_val else 0
    out = np.zeros(n)
    for i, v in idx_val:
        out[int(i) - 1] = float(v)
    return label, out
