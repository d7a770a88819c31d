"""Unsupervised/online speaker adaptation support (NIST unsupervised
protocol; port of lia_ral_tpu/backend/unsupervised.py).

Equivalent of reference ``LIA_SpkTools/UnsupervisedTools``
(UnsupervisedTools.h): WMAP/WMAPGMM score→posterior weighting
(h:124-128, cpp:874+), fast LLR (h:108-115), windowed LLR (WindowLLR
class h:224-239), and the incremental weighted-EM MAP update used by
``LIA_SpkDet/SpkAdapt`` (TrainTargetAdapt, SpkAdapt.cpp:90):
computeMAPmodelFromEMones (h:136) — MAP from EM statistics accumulated
across trial utterances, each weighted by its WMAP posterior.

Score arithmetic is numpy on the host; frames, masks and models are
tensors on one device.  ``UnsupervisedAdapter`` and ``cross_valid`` take
their statistics from the f32 path ``em_stats_chunked`` on every device,
as the JAX package calls it by name (they are no consumers of kernel K1).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..gmm.kernels import EmStats, em_stats_chunked, frame_llk
from ..gmm.map_adapt import MapCfg, map_adapt
from ..gmm.em import m_step
from ..gmm.model import GmmDiag


def wmap(scores: np.ndarray, tar_mean: float, tar_std: float,
         imp_mean: float, imp_std: float, prior_tar: float = 0.5,
         llk_floor: float = -200.0) -> np.ndarray:
    """Gaussian WMAP (reference WMAP, cpp:874): posterior P(target|score)
    with single-Gaussian score models."""
    def logpdf(s, mu, sd):
        return (-0.5 * math.log(2 * math.pi) - np.log(sd)
                - 0.5 * ((s - mu) / sd) ** 2)
    lt = np.maximum(logpdf(scores, tar_mean, tar_std), llk_floor)
    ln = np.maximum(logpdf(scores, imp_mean, imp_std), llk_floor)
    pt = prior_tar * np.exp(lt)
    pn = (1.0 - prior_tar) * np.exp(ln)
    return pt / np.maximum(pt + pn, 1e-300)


def wmap_gmm(scores: np.ndarray, tar: GmmDiag, imp: GmmDiag,
             prior_tar: float = 0.5, llk_floor: float = -200.0
             ) -> np.ndarray:
    """GMM-based WMAP (reference WMAPGMM/FixedPriors): 1-D score GMMs for
    the target and impostor distributions."""
    s = torch.as_tensor(np.asarray(scores, np.float32),
                        device=tar.device)[:, None]
    lt = np.maximum(frame_llk(s, tar).cpu().numpy(), llk_floor)
    ln = np.maximum(frame_llk(s, imp).cpu().numpy(), llk_floor)
    pt = prior_tar * np.exp(lt)
    pn = (1.0 - prior_tar) * np.exp(ln)
    return pt / np.maximum(pt + pn, 1e-300)


def windowed_llr(llr: np.ndarray, window: int, step: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Sliding-window mean LLR (reference WindowLLR, h:224-239):
    returns (window start indices, mean LLR per window) via prefix sums."""
    n = llr.shape[0]
    if n < window:
        return np.zeros(0, np.int64), np.zeros(0)
    c = np.concatenate([[0.0], np.cumsum(llr)])
    starts = np.arange(0, n - window + 1, step)
    means = (c[starts + window] - c[starts]) / window
    return starts, means


def expand_llr(scores: np.ndarray, theta: float, beta: float) -> np.ndarray:
    """Logistic-regression trial weights (reference expandLLR,
    UnsupervisedTools.cpp:847-863, config keys THETA/BETA):
    σ(θ + β·LLR)."""
    z = theta + beta * np.asarray(scores, np.float64)
    return 1.0 / (1.0 + np.exp(-z))


def compute_priors(decisions: np.ndarray, init_prior_tar: float,
                   init_prior_imp: float, optimal_score: float
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Online target/impostor prior updates over the trial sequence
    (reference computePriors, cpp:1062-1100): each trial above
    ``optimalScore`` counts as a target.  Element 0 is the enrollment
    (never counted).  Returns (priorTar, priorImp) per trial."""
    n = len(decisions)
    pt = np.full(n, init_prior_tar / (init_prior_tar + init_prior_imp))
    tar, imp = init_prior_tar, init_prior_imp
    for e in range(1, n):
        if decisions[e] > optimal_score:
            tar += 1
        else:
            imp += 1
        pt[e] = tar / (tar + imp)
    return pt, 1.0 - pt


def oracle(id_tar: str, id_test: str, score: float,
           target_tests: list[tuple[str, str]],
           wmap_type: bool = False, classical_type: bool = True,
           tar: GmmDiag | None = None, imp: GmmDiag | None = None,
           prior_tar: float = 0.5) -> float:
    """Ground-truth adaptation weights (reference Oracle, cpp:1377-1429):
    for a true target trial return weight 1 (classical) or the WMAP-GMM
    posterior of the score (wmap type); impostor trials get weight 0.
    ``target_tests``: (model id, test id) pairs of the true-target list
    (the reference's ``targetTests`` file, columns 0 and 2)."""
    if (id_tar, id_test) in set(target_tests):
        if wmap_type:
            return float(wmap_gmm(np.asarray([score]), tar, imp,
                                  prior_tar=prior_tar)[0])
        if classical_type:
            return 1.0
    return 0.0


# -- T/Z-norm parameter caches -------------------------------------------------

@dataclasses.dataclass
class NormParams:
    """Per-entity impostor-score distribution (reference Norm class,
    cpp:1169-1180)."""
    mu: float
    sigma: float


def load_tnorm_param(entity_ids: list[str],
                     res_lines: list[tuple[str, str, float]],
                     field: str = "test") -> dict[str, NormParams]:
    """T-norm parameter cache from impostor trial scores (reference
    loadTnormParam, cpp:1184-1234): per test id, mean/std of all
    impostor-model scores for that test.  ``res_lines`` are
    (model, test, score) triples; ``field`` selects which column keys the
    cache ('test' → tnorm over imp_seg.res, 'model' → znorm layout)."""
    out: dict[str, NormParams] = {}
    for ent in entity_ids:
        vals = np.asarray([s for m, t, s in res_lines
                           if (t if field == "test" else m) == ent])
        if vals.size == 0:
            continue
        out[ent] = NormParams(float(vals.mean()),
                              float(np.sqrt(np.maximum(
                                  (vals ** 2).mean() - vals.mean() ** 2,
                                  1e-12))))
    return out


def compute_and_store_znorm_param(
    client_model: GmmDiag, world: GmmDiag,
    imp_utts: list[tuple[torch.Tensor, torch.Tensor]],
    imp_ids: list[str] | None = None,
    tnorm_cache: dict[str, NormParams] | None = None,
    top_k: int = 10,
) -> NormParams:
    """Online Z-norm parameters (reference computeAndStoreZnormParam,
    h:155): score the client model against an impostor utterance list;
    if a T-norm cache is given the impostor scores are T-normed first
    (→ ZT-norm parameters)."""
    from ..gmm.scoring import compute_test_llr, stack_gmms
    clients = stack_gmms([client_model])
    scores = []
    for i, (x, w) in enumerate(imp_utts):
        s = float(compute_test_llr(
            x, w, world, clients, top_k=min(top_k, world.n_components))[0])
        if tnorm_cache is not None and imp_ids is not None:
            s = normalize_score(imp_ids[i], s, tnorm_cache)
        scores.append(s)
    v = np.asarray(scores)
    return NormParams(float(v.mean()), float(max(v.std(), 1e-12)))


def normalize_score(entity: str, score: float,
                    cache: dict[str, NormParams],
                    shift: float = 0.0) -> float:
    """(score − μ)/σ − shift against the entity's cached distribution
    (reference normalizeScore, cpp:1237-1280); unknown entities pass
    through unchanged, as in the reference."""
    p = cache.get(entity)
    if p is None:
        return score
    return (score - p.mu) / p.sigma - shift


def search_llr_from_res_file(res_lines: list[tuple[str, str, float]],
                             id_tar: str, id_test: str) -> float | None:
    """Reuse a previously computed LLR from a score file (reference
    searchLLRFromResFile, cpp:1500)."""
    for m, t, s in res_lines:
        if m == id_tar and t == id_test:
            return s
    return None


def fuse_map_means(m1: GmmDiag, w1: float, m2: GmmDiag, w2: float
                   ) -> GmmDiag:
    """Weighted fusion of two MAP models' means (reference fuseMAPMeans,
    cpp:1757); weights/covariances from the first model."""
    tot = max(w1 + w2, 1e-30)
    return m1.replace(means=(w1 * m1.means + w2 * m2.means) / tot)


def cross_valid(
    generator: torch.Generator, x: torch.Tensor, w: torch.Tensor,
    world: GmmDiag,
    map_cfg: MapCfg, selected_train: float = 0.8, average_it: int = 4,
    top_k: int = 10,
) -> tuple[GmmDiag, torch.Tensor, float]:
    """Jack-knife enrollment-data selection (reference crossValid,
    cpp:1432-1498): ``average_it`` times, train a 1-EM-it MAP model on a
    bagged ``selected_train`` fraction and score the held-out fraction;
    keep the split with the LOWEST held-out LLR (the most pessimistic —
    reference keeps LLR < previousLLR).  Returns (EM model of the best
    split, its bagged mask, its held-out LLR)."""
    from ..gmm.em import bagged_frame_mask
    from ..gmm.scoring import compute_test_llr, stack_gmms
    best = None
    for _ in range(average_it):
        sel = bagged_frame_mask(generator, w, selected_train)
        unsel = torch.where(sel > 0, torch.zeros_like(w), w)
        st = em_stats_chunked(x, sel, world)
        em_model = m_step(st)
        client = map_adapt(world, em_model, st.count, map_cfg)
        llr = float(compute_test_llr(
            x, unsel, world, stack_gmms([client]),
            top_k=min(top_k, world.n_components))[0])
        if best is None or llr < best[2]:
            best = (em_model, sel, llr)
    return best


@dataclasses.dataclass
class UnsupervisedAdapter:
    """Sequential WMAP-weighted incremental MAP (reference
    TrainTargetAdapt flow, SpkAdapt.cpp:90): keeps running EM statistics
    of all accepted/weighted test data plus the enrollment data and
    re-derives the MAP model after each trial."""

    world: GmmDiag
    map_cfg: MapCfg
    model: GmmDiag = None
    stats: EmStats = None

    def __post_init__(self):
        if self.model is None:
            self.model = self.world
        if self.stats is None:
            k, d = self.world.means.shape
            self.stats = EmStats.zeros(k, d, device=self.world.device)

    def enroll(self, x: torch.Tensor, w: torch.Tensor) -> None:
        """Add enrollment data with weight 1 and update the model."""
        self._accumulate(x, w, 1.0)

    def process_trial(self, x: torch.Tensor, w: torch.Tensor,
                      trial_weight: float) -> None:
        """Add one test utterance weighted by its WMAP posterior
        (reference weighted-frame EM)."""
        if trial_weight <= 1e-4:
            return
        self._accumulate(x, w, trial_weight)

    def _accumulate(self, x, w, scale: float) -> None:
        st = em_stats_chunked(x, w * scale, self.model)
        self.stats = self.stats.merge(st)
        # computeMAPmodelFromEMones: MAP combine of accumulated EM stats
        em_model = m_step(self.stats)
        self.model = map_adapt(self.world, em_model, self.stats.count,
                               self.map_cfg)

    def score(self, x: torch.Tensor, w: torch.Tensor, top_k: int = 10) -> float:
        from ..gmm.scoring import compute_test_llr, stack_gmms
        return float(compute_test_llr(
            x, w, self.world, stack_gmms([self.model]),
            top_k=min(top_k, self.world.n_components))[0])


def online_znorm_params(client_model: GmmDiag, world: GmmDiag,
                        cohort_x: torch.Tensor, cohort_w: torch.Tensor,
                        top_k: int = 10) -> NormParams:
    """Z-norm parameters of ONE (possibly just-adapted) client model
    against a padded impostor-cohort batch, in one batched pass.

    The adaptation loop shifts every score of an adapting model upward
    as it absorbs data (measured: impostor scores of a 4-trial-adapted
    model overtake the target scores of an unadapted one), so pooled
    EER needs per-model-state normalisation.  The reference could not
    afford rescoring the cohort after every trial on CPU — it computes
    Z-norm once per client (computeAndStoreZnormParam call,
    SpkAdapt.cpp:393) and corrects later drift with a PRECOMPUTED
    frame-count→shift lookup table (SpkAdapt.cpp:717-733, commented
    "TEST SHIFT TNORM").  On an accelerator the honest computation is one
    batched (C,T,K) pass per model update — this function.
    """
    from ..gmm.scoring import compute_test_llr_batch, stack_gmms
    c, t = cohort_x.shape[:2]
    if c < 2:
        raise ValueError(f"online_znorm_params: impostor cohort has {c} "
                         f"file(s); need >= 2 for a usable score std")
    groups = torch.arange(t, device=cohort_x.device)[None].expand(c, t)
    llr = compute_test_llr_batch(
        cohort_x, cohort_w, world, stack_gmms([client_model]), groups,
        top_k=min(top_k, world.n_components))[:, 0].cpu().numpy()
    sigma = float(llr.std())
    if sigma < 1e-4:
        # a near-constant cohort blows Z-normed scores up by 1/σ and
        # silently wrecks downstream WMAP weighting; warn LOUDLY and
        # clamp (an unadapted client == world scores every cohort file
        # exactly 0.0, so this is reachable in legitimate setups)
        import warnings
        warnings.warn(
            f"online_znorm_params: near-degenerate impostor cohort "
            f"(score std {sigma:.2e} < 1e-4); Z-normed scores will be "
            f"scaled by >= 1e4 — use a larger or more diverse cohort",
            RuntimeWarning, stacklevel=2)
        sigma = max(sigma, 1e-6)
    return NormParams(float(llr.mean()), sigma)
