"""Feature front end: MFCC and SDC extraction, normalisation (NormFeat)
and energy VAD (EnergyDetector)."""

from .energy_vad import EnergyDetectorCfg, energy_detector
from .mfcc import MfccCfg, add_deltas, mfcc
from .normfeat import (cmvn_global, cmvn_segmental, cmvn_window,
                       feature_mapping, feature_warping)
from .sdc import shifted_delta_cepstra

__all__ = ["EnergyDetectorCfg", "MfccCfg", "add_deltas", "cmvn_global",
           "cmvn_segmental", "cmvn_window", "energy_detector",
           "feature_mapping", "feature_warping", "mfcc",
           "shifted_delta_cepstra"]
