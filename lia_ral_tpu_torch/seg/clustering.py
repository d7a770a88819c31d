"""Speaker-clustering criteria: CLR, GLLR, BIC, ΔBIC, merging loops
(port of lia_ral_tpu/seg/clustering.py).

Equivalent of reference ``LIA_SpkTools/ClusteringCriterion``
(ClusteringCriterion.cpp): clrCrit (cpp:71-98), gllrCrit (cpp:104-125),
bicCrit (cpp:130-142: −GLLR − λ·P with P = ½(2D+1)K·log(n1+n2)),
deltabicCrit (cpp:144-150: = GLLR), clusteringCriterionByAdapt
(cpp:155-207), clusteringCriterion EM variant (cpp:211-290),
isSimilarSegment (cpp:562-581), bestFittingSegment (cpp:607-731),
bestFittingCluster (cpp:736-755), cohortMaxLikelihood (cpp:585-604),
intraCluster/interCluster purity passes (cpp:760-800).

Criteria operate on frame arrays with masks and GmmDiag models; LLKs come
from the shared GMM kernels.  Segments are (begin, end) frame ranges over
one frame array; per-segment mean LLKs are computed with one frame_llk
pass per model plus a cumulative-sum gather, so the whole search stage is
a handful of tensor reductions rather than the reference's per-segment
re-reads.  Frames and masks are tensors on one device; random draws (the
bagged masks of the EM variant) come from a ``torch.Generator``.  Each
criterion returns a Python float.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gmm.kernels import frame_llk
from ..gmm.model import GmmDiag

Segment = tuple[int, int]  # (begin, end) frame range, end exclusive


def _mean_llk(x, w, gmm) -> float:
    llk = frame_llk(x, gmm)
    return float(torch.sum(llk * w) / torch.clamp(torch.sum(w), min=1e-30))


def _acc_llk(x, w, gmm) -> float:
    return float(torch.sum(frame_llk(x, gmm) * w))


def clr_crit(x, w1, w2, m1: GmmDiag, m2: GmmDiag, world: GmmDiag) -> float:
    """Cross-likelihood ratio (cpp:71-98): (LLK_m1(c2) − LLK_W(c2)) +
    (LLK_m2(c1) − LLK_W(c1)), mean-per-frame LLKs."""
    return ((_mean_llk(x, w2, m1) - _mean_llk(x, w2, world))
            + (_mean_llk(x, w1, m2) - _mean_llk(x, w1, world)))


def gllr_crit(x, w1, w2, m1: GmmDiag, m2: GmmDiag, m12: GmmDiag) -> float:
    """Generalised LLR (cpp:104-125): LLK_m12(c1∪c2) − LLK_m1(c1) −
    LLK_m2(c2), accumulated (not mean) LLKs."""
    w12 = torch.maximum(w1, w2)
    return (_acc_llk(x, w12, m12)
            - (_acc_llk(x, w1, m1) + _acc_llk(x, w2, m2)))


def bic_crit(x, w1, w2, m1: GmmDiag, m2: GmmDiag, m12: GmmDiag,
             lam: float = 1.0) -> float:
    """BIC (cpp:130-142): −GLLR − λ·½·(2D+1)·K·log(n1+n2)."""
    gllr = gllr_crit(x, w1, w2, m1, m2, m12)
    d = m1.dim
    k = m1.n_components
    n = float(torch.sum(w1) + torch.sum(w2))
    p = 0.5 * ((2 * d + 1) * k) * np.log(max(n, 1.0))
    return -gllr - lam * p


def delta_bic_crit(x, w1, w2, m1: GmmDiag, m2: GmmDiag,
                   m12: GmmDiag) -> float:
    """ΔBIC (cpp:144-150) — identical to GLLR in the reference."""
    return gllr_crit(x, w1, w2, m1, m2, m12)


def _seg_mask(n: int, seg: Segment, device=None) -> torch.Tensor:
    m = torch.zeros((n,), dtype=torch.float32, device=device)
    m[seg[0]:seg[1]] = 1.0
    return m


def merge_cluster(c1: list[Segment], c2: list[Segment]) -> list[Segment]:
    """Merge two clusters' segment lists (reference mergeCluster,
    ClusteringCriterion.cpp:79)."""
    return sorted(c1 + c2)


def segment_mean_llk(x: torch.Tensor, segments: list[Segment],
                     gmm: GmmDiag) -> np.ndarray:
    """Mean frame LLK of each (begin, end) segment under one model:
    one frame_llk pass + cumsum gather (replaces the reference's
    meanLikelihood per-segment frame loops, GeneralTools.h:203)."""
    llk = frame_llk(x, gmm)
    cs = torch.cat([torch.zeros((1,), dtype=llk.dtype, device=llk.device),
                    torch.cumsum(llk, dim=0)]).cpu().numpy()
    b = np.asarray([s[0] for s in segments], np.int64)
    e = np.asarray([s[1] for s in segments], np.int64)
    sums = cs[e] - cs[b]
    return sums / np.maximum(e - b, 1)


def clustering_criterion_by_adapt(
    generator: torch.Generator, x: torch.Tensor, seg1: Segment, seg2: Segment,
    world: GmmDiag, crit: str, map_reg: float = 16.0,
) -> float:
    """Criterion between two segments with models MAP-adapted from the
    world (reference clusteringCriterionByAdapt, cpp:155-207: MAPOccDep,
    meanReg=16, baggedFrameProbability=1)."""
    from ..gmm.map_adapt import MapCfg, adapt_model
    n = x.shape[0]
    cfg = MapCfg(method="MAPOccDep", mean_adapt=True, mean_r=map_reg,
                 nb_train_it=1)
    w1, w2 = _seg_mask(n, seg1, x.device), _seg_mask(n, seg2, x.device)
    m1 = adapt_model(generator, x, w1, world, cfg)
    m2 = adapt_model(generator, x, w2, world, cfg)
    if crit in ("GLR", "BIC"):
        m12 = adapt_model(generator, x, torch.maximum(w1, w2), world, cfg)
        if crit == "GLR":
            return gllr_crit(x, w1, w2, m1, m2, m12)
        return bic_crit(x, w1, w2, m1, m2, m12)
    if crit == "CLR":
        return clr_crit(x, w1, w2, m1, m2, world)
    if crit == "DELTABIC":
        m12 = adapt_model(generator, x, torch.maximum(w1, w2), world, cfg)
        return delta_bic_crit(x, w1, w2, m1, m2, m12)
    raise ValueError(f"unknown clustering criterion {crit!r}")


def clustering_criterion_em(
    generator: torch.Generator, x: torch.Tensor, seg1: Segment, seg2: Segment,
    world: GmmDiag, crit: str, nb_train_it: int = 10,
    bagged_frame_probability: float = 0.8,
) -> float:
    """Criterion with models EM-trained from a world-initialised copy
    (reference clusteringCriterion / clusteringCriterionWithoutWorldInit,
    cpp:211-290: trainModel with baggedFrameProbability=0.8, 10 its)."""
    from ..gmm.em import TrainCfg, train_model
    n = x.shape[0]
    cfg = TrainCfg(nb_train_it=nb_train_it,
                   bagged_frame_probability=bagged_frame_probability)
    w1, w2 = _seg_mask(n, seg1, x.device), _seg_mask(n, seg2, x.device)
    m1 = train_model(generator, x, w1, world, cfg)
    m2 = train_model(generator, x, w2, world, cfg)
    if crit in ("GLR", "BIC", "DELTABIC"):
        m12 = train_model(generator, x, torch.maximum(w1, w2), world, cfg)
        if crit == "GLR":
            return gllr_crit(x, w1, w2, m1, m2, m12)
        if crit == "BIC":
            return bic_crit(x, w1, w2, m1, m2, m12)
        return delta_bic_crit(x, w1, w2, m1, m2, m12)
    if crit == "CLR":
        return clr_crit(x, w1, w2, m1, m2, world)
    raise ValueError(f"unknown clustering criterion {crit!r}")


def is_similar_segment(
    generator: torch.Generator, x: torch.Tensor, seg1: Segment, seg2: Segment,
    world: GmmDiag, crit: str, threshold: float = 0.0,
) -> bool:
    """Same-speaker decision between two segments (reference
    isSimilarSegment, cpp:562-581): BIC/CLR/DELTABIC similar when
    criterion > threshold, GLR similar when < threshold."""
    v = clustering_criterion_em(generator, x, seg1, seg2, world, crit)
    if crit in ("BIC", "CLR", "DELTABIC"):
        return v > threshold
    return v < threshold


def cohort_max_likelihood(x: torch.Tensor, models: list[GmmDiag],
                          seg: Segment, except_ind: int | None = None
                          ) -> float:
    """Max mean LLK of a segment over a model cohort (reference
    cohortMaxLikelihood, cpp:585-604)."""
    vals = [float(segment_mean_llk(x, [seg], m)[0])
            for i, m in enumerate(models) if i != except_ind]
    return max(vals)


def best_fitting_segment(
    x: torch.Tensor, cluster: list[Segment], model: GmmDiag,
    world: GmmDiag | None = None,
    cohort: list[GmmDiag] | None = None, except_ind: int | None = None,
    min_len: int = 600,
) -> int | None:
    """Index of the cluster's best segment by (normalised) mean LLK,
    preferring segments longer than ``min_len`` frames (reference
    bestFittingSegment, cpp:607-731: candidates shorter than 600 frames
    are exhausted first; returns None if no long-enough segment exists).
    Normalisation: mean LLK of the world model, or max over a cohort of
    other states' models (the hmm/except overload)."""
    if not cluster:
        return None
    llr = segment_mean_llk(x, cluster, model)
    if world is not None:
        llr = llr - segment_mean_llk(x, cluster, world)
    elif cohort is not None:
        norm = np.stack([segment_mean_llk(x, cluster, m)
                         for i, m in enumerate(cohort) if i != except_ind])
        llr = llr - norm.max(axis=0)
    lengths = np.asarray([e - b for b, e in cluster])
    order = np.argsort(-llr)
    for ind in order:
        if lengths[ind] > min_len:
            return int(ind)
    return None


def best_fitting_cluster(
    x: torch.Tensor, models: list[GmmDiag], seg: Segment,
    except_ind: int | None = None,
) -> int:
    """Index of the model/cluster best explaining a segment by mean LLK
    (reference bestFittingCluster, cpp:736-755)."""
    best, best_v = -1, -np.inf
    for i, m in enumerate(models):
        if i == except_ind:
            continue
        v = float(segment_mean_llk(x, [seg], m)[0])
        if v > best_v:
            best, best_v = i, v
    return best


def intra_cluster(
    generator: torch.Generator, x: torch.Tensor, clusters: list[list[Segment]],
    models: list[GmmDiag], world: GmmDiag, crit: str,
    threshold: float = 0.0, min_len: int = 600,
) -> list[list[bool]]:
    """Intra-cluster purity (reference intraCluster, cpp:760-775): for
    each cluster, compare every segment against the cluster's best
    fitting segment; returns per-cluster lists of is-similar flags
    (True = segment agrees with the cluster's dominant speaker)."""
    out = []
    for ci, cluster in enumerate(clusters):
        ref = best_fitting_segment(x, cluster, models[ci], world=world,
                                   min_len=min_len)
        if ref is None:
            out.append([True] * len(cluster))
            continue
        flags = []
        for seg in cluster:
            flags.append(is_similar_segment(generator, x, cluster[ref], seg,
                                            world, crit, threshold))
        out.append(flags)
    return out


def inter_cluster(
    generator: torch.Generator, x: torch.Tensor, clusters: list[list[Segment]],
    models: list[GmmDiag], world: GmmDiag, crit: str,
    threshold: float = 0.0, min_len: int = 600,
) -> list[list[tuple[int, int]]]:
    """Inter-cluster purity (reference interCluster, cpp:780-800): for
    each cluster's best segment, find segments of OTHER clusters similar
    to it.  Returns, per cluster, the (other_cluster, segment_idx) pairs
    that matched — candidates for merging/reassignment."""
    out = []
    for ci, cluster in enumerate(clusters):
        ref = best_fitting_segment(x, cluster, models[ci], world=world,
                                   min_len=min_len)
        matches: list[tuple[int, int]] = []
        if ref is not None:
            for oi, other in enumerate(clusters):
                if oi == ci:
                    continue
                for si, seg in enumerate(other):
                    if is_similar_segment(generator, x, cluster[ref], seg, world,
                                          crit, threshold):
                        matches.append((oi, si))
        out.append(matches)
    return out


def glr_window_distance(x1: np.ndarray, x2: np.ndarray) -> float:
    """Single-Gaussian GLR between two windows (TurnDetection.cpp:54-78):
    n·log|Σ12| − n1·log|Σ1| − n2·log|Σ2| with diagonal covariances."""
    n1, n2 = x1.shape[0], x2.shape[0]
    x12 = np.concatenate([x1, x2])
    def logdet(x):
        return np.sum(np.log(np.maximum(x.var(axis=0), 1e-8)))
    return ((n1 + n2) * logdet(x12) - n1 * logdet(x1) - n2 * logdet(x2))
