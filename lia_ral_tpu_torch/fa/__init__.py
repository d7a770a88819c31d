"""Factor analysis: Baum-Welch stats and the TotalVariability model."""

from .stats import BwStats, bw_stats_batch, bw_stats_bucketed
from .tv import TvModel, estimate_w, init_t

__all__ = ["BwStats", "TvModel", "bw_stats_batch", "bw_stats_bucketed",
           "estimate_w", "init_t"]
