"""ComputeNorm: score normalisation CLI over NIST score files (port of
lia_ral_tpu/tools/compute_norm.py).

Equivalent of reference ``LIA_SpkDet/ComputeNorm`` (ComputeNorm.cpp:
491-765): tnorm | znorm | ztnorm | tznorm (``normType``), driven by a main
score file and impostor score files, writing a normalised NIST score
file.  Supports ``meanMode`` (0 mean / 1 median+MAD), ``percentH`` /
``percentL`` trimming (cpp:127-135), impostor selection through
``impostorIDList`` (cpp:511-514) and the score-file field positions
``fieldGender/fieldName/fieldSeg/fieldLLR`` (cpp:519-523).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..backend.norm import tnorm, tznorm, znorm, ztnorm
from ..config import Config
from ..io.nist import ScoreLine, write_nist_scores
from .common import resolve_device, setup_verbose


def _read_lines(path: str, fields: tuple[int, int, int, int]
                ) -> list[ScoreLine]:
    """Read a score file by configurable field positions (fieldGender,
    fieldName, fieldSeg, fieldLLR)."""
    fg, fn, fs, fl = fields
    out: list[ScoreLine] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            p = line.split()
            if len(p) <= max(fg, fn, fs, fl):
                continue
            out.append(ScoreLine(p[fg], p[fn], "-", p[fs], float(p[fl])))
    return out


def _score_matrix(lines: list[ScoreLine]
                  ) -> tuple[np.ndarray, list[str], list[str]]:
    """(models × segments) matrix in first-seen order, NaN where a trial
    is absent."""
    models = list(dict.fromkeys(ln.model for ln in lines))
    segs = list(dict.fromkeys(ln.seg for ln in lines))
    mi = {m: i for i, m in enumerate(models)}
    si = {s: i for i, s in enumerate(segs)}
    mat = np.full((len(models), len(segs)), np.nan)
    for ln in lines:
        mat[mi[ln.model], si[ln.seg]] = ln.score
    return mat, models, segs


def main(cfg: Config) -> list[ScoreLine]:
    verbose = setup_verbose(cfg)
    dev = resolve_device(cfg)
    mode = cfg.get_str("normType", "tnorm")
    use_median = cfg.get_str("meanMode", "0") in ("1", "median")
    kw = dict(use_median=use_median,
              percent_h=cfg.get_float("percentH", 0.0),
              percent_l=cfg.get_float("percentL", 0.0))
    fields = (cfg.get_int("fieldGender", 0), cfg.get_int("fieldName", 1),
              cfg.get_int("fieldSeg", 3), cfg.get_int("fieldLLR", 4))
    imp_ids: set[str] | None = None
    if cfg.exists("impostorIDList"):
        with open(cfg.get_str("impostorIDList")) as f:
            imp_ids = {ln.split()[0] for ln in f if ln.strip()}

    main_lines = _read_lines(cfg.get_str("testNistFile"), fields)
    scores, models, segs = _score_matrix(main_lines)

    def tensor(mat):
        # absent trials stay out of the impostor statistics through the
        # masks (ragged per-entity distributions, never a fill)
        return torch.as_tensor(np.nan_to_num(mat, nan=0.0), dtype=torch.float32,
                               device=dev)

    def load_matrix(key: str, imp_models: bool):
        lines = _read_lines(cfg.get_str(key), fields)
        if imp_ids is not None and imp_models:
            lines = [ln for ln in lines if ln.model in imp_ids]
        return _score_matrix(lines)

    def pair(mat):
        return tensor(mat), torch.as_tensor(~np.isnan(mat), device=dev)

    s = tensor(scores)
    if mode == "tnorm":
        # impostor models scored against the SAME test segments
        imp, _, imp_segs = load_matrix("tnormNistFile", imp_models=True)
        mat, msk = pair(imp[:, [imp_segs.index(x) for x in segs]])
        out = tnorm(s, mat, impostor_mask=msk, **kw)
    elif mode == "znorm":
        imp, imp_models, _ = load_matrix("znormNistFile", imp_models=False)
        mat, msk = pair(imp[[imp_models.index(m) for m in models]])
        out = znorm(s, mat, impostor_mask=msk, **kw)
    elif mode in ("ztnorm", "tznorm"):
        impz, impz_models, _ = load_matrix("znormNistFile", imp_models=False)
        impt, _, impt_segs = load_matrix("tnormNistFile", imp_models=True)
        impc, _, _ = load_matrix("ztnormNistFile", imp_models=True)
        zmat, zmsk = pair(impz[[impz_models.index(m) for m in models]])
        tmat, tmsk = pair(impt[:, [impt_segs.index(x) for x in segs]])
        cmat, cmsk = pair(impc)
        fn = ztnorm if mode == "ztnorm" else tznorm
        out = fn(s, zmat, tmat, cmat, z_mask=zmsk, t_mask=tmsk,
                 cross_mask=cmsk, **kw)
    else:
        raise ValueError(f"unknown normType {mode}")

    out = out.cpu().numpy()
    by_key = {(ln.model, ln.seg): ln for ln in main_lines}
    results = []
    for i, m in enumerate(models):
        for j, x in enumerate(segs):
            if (m, x) in by_key:
                ln = by_key[(m, x)]
                results.append(ScoreLine(ln.gender, m, ln.decision, x,
                                         float(out[i, j]), begin=ln.begin,
                                         end=ln.end))
    write_nist_scores(cfg.get_str("outputFileBaseName"), results)
    if verbose:
        print(f"{mode}: normalised {len(results)} scores")
    return results


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
