"""Evaluation metrics: EER, minDCF, DET points (copied from
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
