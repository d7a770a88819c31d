"""i-vector back end: scoring and evaluation metrics."""

from .eval import det_curve, eer, min_dcf
from .scoring import cosine_scores

__all__ = ["cosine_scores", "det_curve", "eer", "min_dcf"]
