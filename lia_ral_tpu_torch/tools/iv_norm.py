"""i-vector file reading for the back-end tools (the ``load_vectors``
helper of lia_ral_tpu/tools/iv_norm.py).

The IvNorm tool itself (EFR / sphNorm and LDA estimation) is not ported
yet; IvTest reads its vectors through ``load_vectors``.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import Config
from ..io.matrix import read_matrix_file


def load_vectors(names: list[str], cfg: Config) -> np.ndarray:
    """(len(names), R) float32 vectors from the per-session .matx files
    IvExtractor writes (loadVectorFilesPath, vectorFilesExtension)."""
    root = cfg.get_str("loadVectorFilesPath",
                       cfg.get_str("saveVectorFilesPath", "./"))
    ext = cfg.get_str("vectorFilesExtension", ".y")
    rows = [read_matrix_file(os.path.join(root, n + ext)).ravel()
            for n in names]
    return np.stack(rows).astype(np.float32)
