"""Feature front end: normalisation (NormFeat) and energy VAD
(EnergyDetector).  MFCC and SDC extraction are not ported yet."""

from .energy_vad import EnergyDetectorCfg, energy_detector
from .normfeat import (cmvn_global, cmvn_segmental, cmvn_window,
                       feature_mapping, feature_warping)

__all__ = ["EnergyDetectorCfg", "cmvn_global", "cmvn_segmental",
           "cmvn_window", "energy_detector", "feature_mapping",
           "feature_warping"]
