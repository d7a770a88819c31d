"""Factor analysis: Baum-Welch stats, the TotalVariability model, JFA and
LFA."""

from .jfa import JfaModel, JfaStats, jfa_train
from .lfa import (compensate_features, compensate_model, estimate_channel,
                  lfa_model, lfa_train)
from .stats import BwStats, bw_stats_batch, bw_stats_bucketed
from .topgauss import TopGauss, compute_topgauss, topgauss_llk
from .tv import TvModel, estimate_w, init_t

__all__ = ["BwStats", "JfaModel", "JfaStats", "TopGauss", "TvModel",
           "bw_stats_batch", "bw_stats_bucketed", "compensate_features",
           "compensate_model", "compute_topgauss", "estimate_channel",
           "estimate_w", "init_t", "jfa_train", "lfa_model", "lfa_train",
           "topgauss_llk"]
