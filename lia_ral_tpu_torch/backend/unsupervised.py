"""Windowed LLR of the NIST unsupervised protocol (port of the
``windowed_llr`` part of lia_ral_tpu/backend/unsupervised.py; numpy on
the host).  The rest of that module (WMAP weighting, the incremental
MAP of SpkAdapt) is not ported yet (ROADMAP queue 1, item 12)."""

from __future__ import annotations

import numpy as np


def windowed_llr(llr: np.ndarray, window: int, step: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Sliding-window mean LLR (reference WindowLLR, h:224-239):
    returns (window start indices, mean LLR per window) via prefix sums."""
    n = llr.shape[0]
    if n < window:
        return np.zeros(0, np.int64), np.zeros(0)
    c = np.concatenate([[0.0], np.cumsum(llr)])
    starts = np.arange(0, n - window + 1, step)
    means = (c[starts + window] - c[starts]) / window
    return starts, means
