"""Evaluation metrics: EER, minDCF, DET points, DER (copied from
lia_ral_tpu/backend/eval.py; numpy on the host)."""

from __future__ import annotations

import numpy as np


def det_curve(target_scores: np.ndarray, impostor_scores: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(thresholds, false-reject rate, false-accept rate) swept over all
    observed scores."""
    t = np.sort(np.asarray(target_scores, np.float64))
    i = np.sort(np.asarray(impostor_scores, np.float64))
    thr = np.unique(np.concatenate([t, i]))
    frr = np.searchsorted(t, thr, side="left") / max(len(t), 1)
    far = 1.0 - np.searchsorted(i, thr, side="right") / max(len(i), 1)
    return thr, frr, far


def eer(target_scores: np.ndarray, impostor_scores: np.ndarray) -> float:
    """Equal error rate (linear interpolation at the FRR=FAR crossing)."""
    _, frr, far = det_curve(target_scores, impostor_scores)
    diff = frr - far
    idx = np.searchsorted(diff > 0, True)
    if idx == 0:
        return float(max(frr[0], far[0]))
    if idx >= len(diff):
        return float(max(frr[-1], far[-1]))
    x0, x1 = diff[idx - 1], diff[idx]
    w = -x0 / (x1 - x0) if x1 != x0 else 0.5
    return float((1 - w) * (frr[idx - 1] + far[idx - 1]) / 2
                 + w * (frr[idx] + far[idx]) / 2)


def min_dcf(target_scores: np.ndarray, impostor_scores: np.ndarray,
            p_target: float = 0.01, c_miss: float = 1.0,
            c_fa: float = 1.0) -> float:
    """Minimum detection cost (NIST DCF), normalised by the best trivial
    system."""
    _, frr, far = det_curve(target_scores, impostor_scores)
    dcf = c_miss * p_target * frr + c_fa * (1 - p_target) * far
    denom = min(c_miss * p_target, c_fa * (1 - p_target))
    return float(dcf.min() / denom)


def der(ref_labels: np.ndarray, hyp_labels: np.ndarray,
        collar_frames: int = 0) -> float:
    """Frame-level Diarization Error Rate with optimal speaker mapping.

    ``ref_labels``/``hyp_labels``: per-frame integer speaker ids
    (negative = non-speech).  The hypothesis→reference speaker mapping
    is the confusion-matrix optimal one-to-one assignment (Hungarian —
    the scoring convention of NIST md-eval); ``collar_frames`` excludes
    frames within that distance of a reference speaker change.
    Returns (missed + false-alarm + confusion) / reference speech.
    """
    from scipy.optimize import linear_sum_assignment

    ref = np.asarray(ref_labels)
    hyp = np.asarray(hyp_labels)
    if ref.shape != hyp.shape:
        raise ValueError(f"der: ref/hyp frame counts differ "
                         f"({ref.shape} vs {hyp.shape})")
    scored = np.ones(ref.shape[0], bool)
    if collar_frames > 0:
        change = np.nonzero(np.diff(ref) != 0)[0]
        for c in change:
            lo = max(0, c + 1 - collar_frames)
            scored[lo:c + 1 + collar_frames] = False
    r, h = ref[scored], hyp[scored]
    ref_speech = r >= 0
    n_ref = int(ref_speech.sum())
    if n_ref == 0:
        return 0.0
    miss = int(np.sum(ref_speech & (h < 0)))
    fa = int(np.sum((~ref_speech) & (h >= 0)))
    both = ref_speech & (h >= 0)
    r_ids = np.unique(r[both])
    h_ids = np.unique(h[both])
    conf_mat = np.zeros((len(r_ids), len(h_ids)), np.int64)
    np.add.at(conf_mat, (np.searchsorted(r_ids, r[both]),
                         np.searchsorted(h_ids, h[both])), 1)
    ri, hi = linear_sum_assignment(-conf_mat)
    matched = int(conf_mat[ri, hi].sum())
    confusion = int(both.sum()) - matched
    return float(miss + fa + confusion) / n_ref
