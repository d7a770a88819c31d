"""Acoustic tokenization: best-Gaussian symbol per frame (port of
lia_ral_tpu/utils/tokenizer.py).

Equivalent of reference ``LIA_Utils/GmmTokenizer`` (test1.sh: emit the
winning component index per frame as a symbol stream + confusion matrix).
"""

from __future__ import annotations

import numpy as np
import torch

from ..gmm.kernels import weighted_logdens
from ..gmm.model import GmmDiag


def gmm_tokenize(x: torch.Tensor, gmm: GmmDiag) -> np.ndarray:
    """Symbol (winning component index) per frame — one argmax over the
    batched log-density matrix, on x's device."""
    return torch.argmax(weighted_logdens(x, gmm), dim=-1).cpu().numpy()


def confusion_matrix(symbols_a: np.ndarray, symbols_b: np.ndarray,
                     n_symbols: int) -> np.ndarray:
    """Co-occurrence counts of two aligned symbol streams (reference
    mce_matrix output)."""
    assert symbols_a.shape == symbols_b.shape
    mat = np.zeros((n_symbols, n_symbols), np.int64)
    np.add.at(mat, (symbols_a, symbols_b), 1)
    return mat
