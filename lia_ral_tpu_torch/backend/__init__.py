"""Back end: i-vector normalisation, PLDA, trial scoring, score
normalisation and evaluation metrics."""

from .eval import det_curve, eer, min_dcf
from .ivnorm import (DevSet, apply_efr, compute_lda, compute_mahalanobis,
                     compute_wccn, efr_iterations, length_norm)
from .norm import tnorm, tznorm, znorm, ztnorm
from .plda import PldaModel, plda_llr, plda_train
from .scoring import (cosine_scores, mahalanobis_scores, two_cov_model,
                      two_cov_scores)

__all__ = ["DevSet", "PldaModel", "apply_efr", "compute_lda",
           "compute_mahalanobis", "compute_wccn", "cosine_scores",
           "det_curve", "eer", "efr_iterations", "length_norm",
           "mahalanobis_scores", "min_dcf", "plda_llr", "plda_train",
           "tnorm", "two_cov_model", "two_cov_scores", "tznorm", "znorm",
           "ztnorm"]
