"""Score-file post-processing: decisions, identification, fusion, warping,
histograms (copied from lia_ral_tpu/utils/scores.py).

Equivalents of reference LIA_Utils tools (SURVEY.md §2.4): Scoring
(Scoring.cpp:72-105 — thresholded decisions + max-score identification),
FusionScore (linear fusion with weights), ScoreWarp
(LIA_SpkTools/ScoreWarp.cpp — warp a score distribution onto a Gaussian
target via histogram CDF matching), Hist (histogram computation).
"""

from __future__ import annotations

import numpy as np

from ..io.nist import ScoreLine


def scoring_decisions(lines: list[ScoreLine], threshold: float
                      ) -> list[ScoreLine]:
    """Reference Scoring decision mode (Scoring.cpp:72-94)."""
    return [ScoreLine(l.gender, l.model,
                      "1" if l.score >= threshold else "0",
                      l.seg, l.score, begin=l.begin, end=l.end)
            for l in lines]


def max_score_identification(lines: list[ScoreLine]) -> list[ScoreLine]:
    """Keep, per segment, the best-scoring model (Scoring.cpp:105+)."""
    best: dict[str, ScoreLine] = {}
    for l in lines:
        if l.seg not in best or l.score > best[l.seg].score:
            best[l.seg] = l
    return list(best.values())


def fuse_scores(score_sets: list[list[ScoreLine]],
                weights: list[float]) -> list[ScoreLine]:
    """Linear fusion of score files (reference FusionScore; fixture
    test/fusion.lst + test/weights): trials matched on (model, seg)."""
    assert len(score_sets) == len(weights)
    acc: dict[tuple[str, str], float] = {}
    meta: dict[tuple[str, str], ScoreLine] = {}
    for lines, w in zip(score_sets, weights):
        for l in lines:
            key = (l.model, l.seg)
            acc[key] = acc.get(key, 0.0) + w * l.score
            meta.setdefault(key, l)
    out = []
    for key, s in acc.items():
        m = meta[key]
        out.append(ScoreLine(m.gender, m.model, m.decision, m.seg, s,
                             begin=m.begin, end=m.end))
    return out


def score_warp(scores: np.ndarray, ref_scores: np.ndarray | None = None,
               target_mean: float = 0.0, target_std: float = 1.0,
               nb_bins: int = 100) -> np.ndarray:
    """Warp scores onto a Gaussian target distribution.

    Reference scoreWarping (ScoreWarp.cpp: raw histogram CDF → target
    Gaussian histogram CDF; makeGausHisto samples the target by
    Box-Muller).  Implemented as exact empirical-CDF → inverse normal CDF
    mapping (the nb_bins→∞ limit of the reference's numerical
    integration); ``ref_scores`` defines the raw distribution (defaults
    to the scores themselves).
    """
    from scipy.special import ndtri
    ref = np.sort(np.asarray(ref_scores if ref_scores is not None
                             else scores, np.float64))
    n = ref.size
    ranks = np.searchsorted(ref, np.asarray(scores, np.float64),
                            side="right")
    p = np.clip((ranks) / (n + 1.0), 1e-6, 1 - 1e-6)
    del nb_bins
    return target_mean + target_std * ndtri(p)


def histogram(values: np.ndarray, nb_bins: int = 100
              ) -> tuple[np.ndarray, np.ndarray]:
    """Density histogram (reference Hist tool / ALIZE Histo semantics:
    Σ count·width = 1)."""
    hist, edges = np.histogram(np.asarray(values), bins=nb_bins,
                               density=True)
    return hist, edges
