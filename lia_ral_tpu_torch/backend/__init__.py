"""Back end: cosine scoring, score normalisation and evaluation metrics."""

from .eval import det_curve, eer, min_dcf
from .norm import tnorm, tznorm, znorm, ztnorm
from .scoring import cosine_scores

__all__ = ["cosine_scores", "det_curve", "eer", "min_dcf", "tnorm",
           "tznorm", "znorm", "ztnorm"]
