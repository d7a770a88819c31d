"""Label-file fusion and time-based filtering (copied from
lia_ral_tpu/utils/labels.py).

Equivalents of reference ``LIA_Utils/LabelFusion`` (merge label files
with morphological windowing) and ``TimeCluster`` (time-based cluster
manipulation of label files) — SURVEY.md §2.4.
"""

from __future__ import annotations

import numpy as np

from ..io.labels import Segment, frame_mask_to_segments, segments_to_frame_mask


def fuse_label_files(
    seg_lists: list[list[Segment]],
    nframes: int,
    frame_length: float = 0.01,
    mode: str = "union",           # union | intersection
    label: str = "speech",
    close_gap: int = 0,            # morphological closing (frames)
    drop_short: int = 0,           # morphological opening (frames)
) -> list[Segment]:
    """Merge several segmentations into one (reference LabelFusion with
    morphological windowing)."""
    masks = [segments_to_frame_mask(s, nframes, frame_length)
             for s in seg_lists]
    if not masks:
        return []
    acc = masks[0].copy()
    for m in masks[1:]:
        acc = (acc | m) if mode == "union" else (acc & m)
    if close_gap > 0:
        acc = _close(acc, close_gap)
    if drop_short > 0:
        acc = _open(acc, drop_short)
    return frame_mask_to_segments(acc, frame_length, label)


def _close(mask: np.ndarray, gap: int) -> np.ndarray:
    """Fill False gaps shorter than ``gap`` between True runs."""
    out = mask.copy()
    n = mask.size
    i = 0
    while i < n:
        if not out[i]:
            j = i
            while j < n and not out[j]:
                j += 1
            if i > 0 and j < n and (j - i) < gap:
                out[i:j] = True
            i = j
        else:
            i += 1
    return out


def _open(mask: np.ndarray, min_len: int) -> np.ndarray:
    """Remove True runs shorter than ``min_len``."""
    out = mask.copy()
    n = mask.size
    i = 0
    while i < n:
        if out[i]:
            j = i
            while j < n and out[j]:
                j += 1
            if (j - i) < min_len:
                out[i:j] = False
            i = j
        else:
            i += 1
    return out


def time_cluster_filter(
    segs: list[Segment],
    min_duration: float = 0.0,
    begin: float | None = None,
    end: float | None = None,
    labels: list[str] | None = None,
) -> list[Segment]:
    """Time/label filtering of a segmentation (reference TimeCluster)."""
    out = []
    for s in segs:
        if labels is not None and s.label not in labels:
            continue
        a = s.begin if begin is None else max(s.begin, begin)
        b = s.end if end is None else min(s.end, end)
        if b - a >= max(min_duration, 0.0) and b > a:
            out.append(Segment(a, b, s.label))
    return out
