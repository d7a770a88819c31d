"""Host-side helpers of the port and the utility algorithms behind the
LIA_Utils tool set (SURVEY.md §2.4): score post-processing, fusion and
warping, polynomial expansion, acoustic tokenization, n-gram counting and
decoding, label fusion."""

from .labels import fuse_label_files, time_cluster_filter
from .ngram import (NGramModel, label_ngram, ngram_counts,
                    read_ngram_codebook, sequence_decode)
from .polyexp import poly_expand, poly_expansion_size
from .scores import (fuse_scores, histogram, max_score_identification,
                     score_warp, scoring_decisions)
from .shapes import FRAME_BUCKET, bucket_len, next_pow2
from .tokenizer import confusion_matrix, gmm_tokenize

__all__ = [
    "FRAME_BUCKET", "bucket_len", "next_pow2",
    "scoring_decisions", "max_score_identification", "fuse_scores",
    "score_warp", "histogram",
    "poly_expand", "poly_expansion_size",
    "gmm_tokenize", "confusion_matrix",
    "ngram_counts", "NGramModel", "sequence_decode",
    "label_ngram", "read_ngram_codebook",
    "fuse_label_files", "time_cluster_filter",
]
