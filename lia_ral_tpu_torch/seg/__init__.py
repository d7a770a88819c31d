"""Diarization stack: HMM/Viterbi, clustering criteria, segmentation tools
(port of lia_ral_tpu/seg).

Equivalent of reference LIA_SpkSeg (SURVEY.md §2.3) and the LIA_SpkTools
Hmm/ClusteringCriterion/Tools components (§2.1): state GMMs are stacked
GmmDiags, Viterbi is a CUDA kernel over the frame axis (a plain loop on
the CPU), clustering criteria are batched LLK reductions.
"""

from .hmm import DiarHmm, viterbi_decode, compute_transitions
from .clustering import (clr_crit, gllr_crit, bic_crit, delta_bic_crit,
                         merge_cluster, segment_mean_llk,
                         clustering_criterion_by_adapt,
                         clustering_criterion_em, is_similar_segment,
                         cohort_max_likelihood, best_fitting_segment,
                         best_fitting_cluster, intra_cluster, inter_cluster)
from .diarization import (
    turn_detection,
    e_hmm_segmentation,
    resegmentation,
    acoustic_segmentation,
    create_world,
    seg_em,
    seg_adaptation,
)

__all__ = [
    "DiarHmm", "viterbi_decode", "compute_transitions",
    "clr_crit", "gllr_crit", "bic_crit", "delta_bic_crit",
    "turn_detection", "e_hmm_segmentation", "resegmentation",
    "acoustic_segmentation", "create_world", "seg_em",
    "seg_adaptation",
]
