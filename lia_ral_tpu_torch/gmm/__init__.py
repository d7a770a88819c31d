"""Diagonal GMMs: model, plain stats path, CUDA kernels K1/K2, UBM EM."""

from .kernels import (EmStats, component_logdens, em_stats, em_stats_chunked,
                      frame_llk, llk_and_posteriors, weighted_logdens)
from .model import GmmDiag

__all__ = ["EmStats", "GmmDiag", "component_logdens", "em_stats",
           "em_stats_chunked", "frame_llk", "llk_and_posteriors",
           "weighted_logdens"]
