"""File I/O of the port: features, labels, mixtures, matrices, lists and
NIST score files (port of lia_ral_tpu/io, numpy only)."""

from .features import (FeatureFile, FeatureServer, apply_mask, parse_mask,
                       read_feature_file, write_feature_file)
from .gmm_io import read_gmm_file, write_gmm_file
from .labels import (Segment, SegmentStore, frame_mask_to_segments,
                     read_label_file, segments_to_frame_mask,
                     write_label_file)
from .lists import read_ndx, read_xlist, write_xlist
from .matrix import read_matrix_file, write_matrix_file
from .nist import ScoreLine, read_nist_scores, write_nist_scores

__all__ = [
    "FeatureFile", "FeatureServer", "apply_mask", "parse_mask",
    "read_feature_file", "write_feature_file",
    "read_gmm_file", "write_gmm_file",
    "Segment", "SegmentStore", "frame_mask_to_segments", "read_label_file",
    "segments_to_frame_mask", "write_label_file",
    "read_ndx", "read_xlist", "write_xlist",
    "read_matrix_file", "write_matrix_file",
    "ScoreLine", "read_nist_scores", "write_nist_scores",
]
