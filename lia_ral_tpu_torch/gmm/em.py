"""GMM-UBM EM training: init, M-step, variance control, bagged subsampling
(port of lia_ral_tpu/gmm/em.py).

Reference ``LIA_SpkTools/src/TrainTools.cpp`` (trainModel cpp:993-1028,
mixtureInit cpp:619-674, varianceControl cpp:567-592, setItParameter
cpp:560-564) and ``GeneralTools.cpp`` baggedSegments (cpp:455-511).
Frames live in one (N,D) tensor (or stream through bounded buffers in
``train_model_streaming``), the bagged subsample is a per-frame weight
mask drawn from an explicit ``torch.Generator``, and the stats pass is
kernel K1 for CUDA tensors, its plain version for CPU ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .cuda_kernels import (check_tier, em_stats_fused,
                           em_stats_reference)
from .kernels import EmStats, em_stats_chunked
from .model import GmmDiag


@dataclasses.dataclass
class TrainCfg:
    """Reference TrainCfg (TrainTools.h:122-160), same config keys."""

    nb_train_it: int = 20
    init_variance_flooring: float = 1.0
    init_variance_ceiling: float = 10.0
    final_variance_flooring: float = 0.5
    final_variance_ceiling: float = 5.0
    bagged_frame_probability: float = 1.0
    bagged_frame_probability_init: float = 0.0
    bagged_minimal_length: int = 3
    bagged_maximal_length: int = 7
    normalize_model: bool = False
    component_reduction: bool = False
    target_distrib_count: int = 0

    @classmethod
    def from_config(cls, cfg) -> "TrainCfg":
        """``cfg``: any object with get_int/get_float/get_bool(key, default)."""
        return cls(
            nb_train_it=cfg.get_int("nbTrainIt", 20),
            init_variance_flooring=cfg.get_float("initVarianceFlooring", 1.0),
            init_variance_ceiling=cfg.get_float("initVarianceCeiling", 10.0),
            final_variance_flooring=cfg.get_float("finalVarianceFlooring", 0.5),
            final_variance_ceiling=cfg.get_float("finalVarianceCeiling", 5.0),
            bagged_frame_probability=cfg.get_float("baggedFrameProbability", 1.0),
            bagged_frame_probability_init=cfg.get_float(
                "baggedFrameProbabilityInit", 0.0),
            bagged_minimal_length=cfg.get_int("baggedMinimalLength", 3),
            bagged_maximal_length=cfg.get_int("baggedMaximalLength", 7),
            normalize_model=cfg.get_bool("normalizeModel", False),
            component_reduction=cfg.get_bool("componentReduction", False),
            target_distrib_count=cfg.get_int("targetMixtureDistribCount", 0),
        )


def default_stats_fn(chunk: int = 4096, block: int | None = None,
                     fast_math: bool = False, fast_stats: bool = False):
    """The stats pass for the input's device.  A CUDA tensor goes to
    kernel K1 (``cuda_kernels.em_stats_fused``, ``block`` frames per CTA
    chunk, by default its own rule).  A CPU tensor goes, in the default
    tier, to the f32 stats path (``kernels.em_stats_chunked``, ``chunk``
    frames at a time), as the JAX package takes its XLA path off the TPU,
    and otherwise to the tier's plain version.  So on the CPU the default
    tier is true f32 here, while ``cuda_kernels.em_stats_fused`` on the
    same CPU tensor gives the plain version of what the card computes
    (three bf16 passes); the two differ by that rounding only, and
    ``cuda_kernels``'s docstring says why both exist.  ``fast_math`` (config key
    ``fastMath``) takes the bf16 logit tier, ``fast_stats``
    (``fastStats``) the bf16 S/F tier with exact occupancies;
    ``cuda_kernels`` says where each rounds."""
    dt = torch.bfloat16 if fast_math else None
    sp = "bf16nx" if fast_stats else "x3"
    check_tier(dt, sp)

    def fn(x, w, gmm):
        if x.device.type == "cuda":
            return em_stats_fused(x, w, gmm, chunk=block, compute_dtype=dt,
                                  stats_pass=sp)
        if not (fast_math or fast_stats):
            return em_stats_chunked(x, w, gmm, chunk=chunk)
        return em_stats_reference(x, w, gmm, chunk=chunk, compute_dtype=dt,
                                  stats_pass=sp)
    return fn


def schedule_value(begin: float, end: float, nb_it: int, it: int) -> float:
    """Linear parameter schedule — reference setItParameter."""
    if nb_it < 2:
        return begin
    return begin - (begin - end) / (nb_it - 1) * it


def global_mean_cov(x: torch.Tensor, w: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted global mean and variance of the frames."""
    cnt = torch.clamp(torch.sum(w), min=1e-30)
    mean = torch.sum(x * w[:, None], dim=0) / cnt
    ex2 = torch.sum(x * x * w[:, None], dim=0) / cnt
    return mean, ex2 - mean * mean


def m_step(stats: EmStats, min_occ: float = 1e-6) -> GmmDiag:
    """Closed-form diagonal-GMM M-step (ALIZE MixtureStat::getEM)."""
    occ = torch.clamp(stats.n, min=min_occ)[:, None]
    means = stats.sum_x / occ
    cov = torch.clamp(stats.sum_xx / occ - means * means, min=1e-8)
    weights = stats.n / torch.clamp(stats.count, min=1e-30)
    wsum = torch.sum(weights)
    # empty selection (all-zero frame weights) → keep a uniform mixture
    weights = torch.where(wsum > 0, weights / torch.clamp(wsum, min=1e-30),
                          torch.full_like(weights, 1.0 / stats.n.shape[0]))
    return GmmDiag(weights=weights, means=means, cov_inv=1.0 / cov)


def variance_control(gmm: GmmDiag, flooring: float, ceiling: float,
                     global_cov: torch.Tensor) -> GmmDiag:
    """Floor/ceil each component variance relative to the global data
    variance — reference varianceControl."""
    cov = torch.clamp(1.0 / gmm.cov_inv, min=flooring * global_cov[None, :],
                      max=ceiling * global_cov[None, :])
    return gmm.replace(cov_inv=1.0 / cov)


def _m_step_with_variance_control(stats: EmStats, flooring, ceiling,
                                  global_cov: torch.Tensor) -> GmmDiag:
    return variance_control(m_step(stats), flooring, ceiling, global_cov)


def normalize_mixture(gmm: GmmDiag, data_mean: torch.Tensor,
                      data_cov: torch.Tensor,
                      mean_only: bool = False) -> GmmDiag:
    """Map the model into a 0-mean/1-var feature space — reference
    normalizeMixture (TrainTools.cpp:287-336)."""
    std = torch.sqrt(data_cov)
    means = (gmm.means - data_mean[None, :]) / std[None, :]
    if mean_only:
        return gmm.replace(means=means)
    cov = (1.0 / gmm.cov_inv) / data_cov[None, :]
    return gmm.replace(means=means, cov_inv=1.0 / cov)


# -- bagged frame selection ---------------------------------------------------

def _bagged_masks(generator: torch.Generator, base_mask: torch.Tensor,
                  probability: float, min_len: int, max_len: int,
                  count: int) -> torch.Tensor:
    """``count`` independent bagged selections of the frames, (count, N):
    fixed average-length chunks with a random phase, each kept with
    ``probability`` (the JAX package's vectorised form of the
    reference's random-length segment walk)."""
    n = base_mask.shape[0]
    chunk_len = max((min_len + max_len) // 2, 1)
    n_chunks = -(-n // chunk_len) + 1
    gdev = generator.device
    keep = torch.rand((count, n_chunks), generator=generator,
                      device=gdev) < probability
    off = torch.randint(0, chunk_len, (count, 1), generator=generator,
                        device=gdev)
    sel = keep.repeat_interleave(chunk_len, dim=1)
    idx = off + torch.arange(n, device=gdev)[None, :]
    sel = torch.gather(sel, 1, idx).to(base_mask.device, base_mask.dtype)
    return base_mask[None, :] * sel


def bagged_frame_mask(generator: torch.Generator, base_mask: torch.Tensor,
                      probability: float, min_len: int = 3,
                      max_len: int = 7) -> torch.Tensor:
    """Random frame subsample as a 0/1 weight mask (reference
    baggedSegments).  ``probability >= 1`` keeps ``base_mask`` as is."""
    if probability >= 1.0:
        return base_mask
    return _bagged_masks(generator, base_mask, probability, min_len,
                         max_len, 1)[0]


# -- init ---------------------------------------------------------------------

def mixture_init(generator: torch.Generator, x: torch.Tensor,
                 w: torch.Tensor, n_components: int,
                 bagged_probability_init: float = 0.1, min_len: int = 3,
                 max_len: int = 7) -> GmmDiag:
    """Init by random frame picking — reference mixtureInit: component
    mean = mean of a random ~p/K frame subset, covariance = global
    covariance, weights = 1/K."""
    _, gcov = global_mean_cov(x, w)
    p = max(bagged_probability_init / n_components, 1e-6)
    gmean = torch.sum(x * w[:, None], dim=0) / torch.clamp(torch.sum(w),
                                                           min=1.0)
    # 128 components at a time bound the live (C, N) mask block
    means = []
    for c0 in range(0, n_components, 128):
        c = min(128, n_components - c0)
        if p >= 1.0:
            masks = w[None, :].expand(c, -1)
        else:
            masks = _bagged_masks(generator, w, p, min_len, max_len, c)
        cnt = torch.sum(masks, dim=-1)
        mean = (masks @ x) / torch.clamp(cnt, min=1.0)[:, None]
        # empty selection → the global weighted mean
        means.append(torch.where(cnt[:, None] > 0, mean, gmean[None, :]))
    k, d = n_components, x.shape[1]
    return GmmDiag(
        weights=torch.full((k,), 1.0 / k, dtype=x.dtype, device=x.device),
        means=torch.cat(means).to(x.dtype),
        cov_inv=(1.0 / torch.clamp(gcov, min=1e-8)).expand(k, d)
        .to(x.dtype).contiguous())


def _split_component(gmm: GmmDiag, idx: int) -> GmmDiag:
    """Split component ``idx`` into mean±sqrt(cov) halves of equal weight
    (the inner step of reference mixtureInitBySplit, Tools.cpp:1057)."""
    sd = torch.sqrt(1.0 / gmm.cov_inv[idx])
    half = gmm.weights[idx] / 2.0
    weights = torch.cat([gmm.weights, half[None]])
    weights[idx] = half
    means = torch.cat([gmm.means, (gmm.means[idx] - sd)[None]])
    means[idx] = gmm.means[idx] + sd
    return GmmDiag(weights=weights, means=means,
                   cov_inv=torch.cat([gmm.cov_inv, gmm.cov_inv[idx][None]]))


def mixture_init_by_split(generator: torch.Generator, x: torch.Tensor,
                          w: torch.Tensor, max_distrib: int,
                          cfg: "TrainCfg | None" = None, stats_fn=None,
                          chunk: int = 4096,
                          verbose: bool = False) -> GmmDiag:
    """Binary-splitting GMM initialisation — reference mixtureInitBySplit
    (Tools.cpp:1057-1240): start from one Gaussian at the global
    mean/covariance; while 2K ≤ max split EVERY component into
    mean±sqrt(cov) halves and EM-retrain; then unitary splits of the
    heaviest component (the first one on a tie) until K == max, EM after
    each.  Used to make the diarization world model (createWorld,
    Tools.cpp:1243).  The only random draws are ``train_model``'s bagged
    masks."""
    cfg = cfg or TrainCfg(nb_train_it=3)
    gmean, gcov = global_mean_cov(x, w)
    gmm = GmmDiag(weights=torch.ones((1,), dtype=x.dtype, device=x.device),
                  means=gmean[None].to(x.dtype),
                  cov_inv=(1.0 / torch.clamp(gcov, min=1e-8))[None]
                  .to(x.dtype))

    def retrain(g):
        return train_model(generator, x, w, g, cfg, stats_fn=stats_fn,
                           chunk=chunk, verbose=verbose)

    while 2 * gmm.n_components <= max_distrib:
        for d in range(gmm.n_components):   # split every component
            gmm = _split_component(gmm, d)
        gmm = retrain(gmm)
        if verbose:
            print(f"split init: {gmm.n_components} components")
    while gmm.n_components < max_distrib:   # unitary splits
        gmm = _split_component(gmm, int(torch.argmax(gmm.weights)))
        gmm = retrain(gmm)
        if verbose:
            print(f"split init (unitary): {gmm.n_components} components")
    return gmm


def reduce_model(gmm: GmmDiag, target_count: int) -> GmmDiag:
    """Keep the heaviest components and renormalise (reference
    selectComponent/reduceModel, TrainTools.cpp:175-222)."""
    idx = torch.argsort(-gmm.weights, stable=True)[:target_count]
    w = gmm.weights[idx]
    return GmmDiag(weights=w / torch.sum(w), means=gmm.means[idx],
                   cov_inv=gmm.cov_inv[idx])


# -- the training loop --------------------------------------------------------

def train_model(generator: torch.Generator, x: torch.Tensor,
                w: torch.Tensor, init: GmmDiag, cfg: TrainCfg,
                stats_fn: Callable[[torch.Tensor, torch.Tensor, GmmDiag],
                                   EmStats] | None = None,
                chunk: int = 4096, verbose: bool = False) -> GmmDiag:
    """UBM EM loop — reference trainModel (TrainTools.cpp:993-1028).

    ``stats_fn(x, w, gmm) -> EmStats`` defaults to ``default_stats_fn``:
    kernel K1 on CUDA tensors, the plain chunked path on CPU ones."""
    if stats_fn is None:
        stats_fn = default_stats_fn(chunk=chunk)
    _, gcov = global_mean_cov(x, w)
    gmm = init
    for it in range(cfg.nb_train_it):
        floor = schedule_value(cfg.init_variance_flooring,
                               cfg.final_variance_flooring,
                               cfg.nb_train_it, it)
        ceil = schedule_value(cfg.init_variance_ceiling,
                              cfg.final_variance_ceiling,
                              cfg.nb_train_it, it)
        mask = bagged_frame_mask(generator, w, cfg.bagged_frame_probability,
                                 cfg.bagged_minimal_length,
                                 cfg.bagged_maximal_length)
        stats = stats_fn(x, mask, gmm)
        if verbose:
            print(f"it {it}: meanLLK={float(stats.mean_llk()):.5f} "
                  f"frames={float(stats.count):.0f} floor={floor:.3f} "
                  f"ceil={ceil:.3f}")
        gmm = _m_step_with_variance_control(stats, floor, ceil, gcov)
    if cfg.component_reduction and cfg.target_distrib_count > 0:
        gmm = reduce_model(gmm, cfg.target_distrib_count)
    return gmm


def train_model_streams(generator: torch.Generator,
                        streams: list[tuple[torch.Tensor, torch.Tensor]],
                        stream_weights: list[float], init: GmmDiag,
                        cfg: TrainCfg, stats_fn=None, chunk: int = 4096,
                        verbose: bool = False) -> GmmDiag:
    """Multi-stream weighted EM — reference trainModelStream
    (TrainTools.cpp:1030-1110): per iteration each stream contributes a
    bagged-subsampled stat accumulator scaled by its stream weight before
    the merge (stream weights balance heterogeneous data sources).  The
    masks are drawn one a stream an iteration, streams in order.

    ``stats_fn`` as in ``train_model``: kernel K1 on CUDA tensors by
    default; a mesh's ``parallel.sharding.sharded_stats_fn`` shards it."""
    if stats_fn is None:
        stats_fn = default_stats_fn(chunk=chunk)
    _, gcov = global_mean_cov(torch.cat([x for x, _ in streams]),
                              torch.cat([w for _, w in streams]))
    gmm = init
    k, d = init.means.shape
    for it in range(cfg.nb_train_it):
        floor = schedule_value(cfg.init_variance_flooring,
                               cfg.final_variance_flooring,
                               cfg.nb_train_it, it)
        ceil = schedule_value(cfg.init_variance_ceiling,
                              cfg.final_variance_ceiling,
                              cfg.nb_train_it, it)
        merged = EmStats.zeros(k, d, device=init.device)
        for (x, w), sw in zip(streams, stream_weights):
            mask = bagged_frame_mask(generator, w,
                                     cfg.bagged_frame_probability,
                                     cfg.bagged_minimal_length,
                                     cfg.bagged_maximal_length)
            st = stats_fn(x, mask, gmm)
            merged = merged.merge(EmStats(*(a * sw for a in (
                st.n, st.sum_x, st.sum_xx, st.llk, st.count))))
        if verbose:
            print(f"stream-it {it}: meanLLK={float(merged.mean_llk()):.5f}")
        gmm = _m_step_with_variance_control(merged, floor, ceil, gcov)
    if cfg.component_reduction and cfg.target_distrib_count > 0:
        gmm = reduce_model(gmm, cfg.target_distrib_count)
    return gmm


def streaming_global_mean_cov(loader, device=None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Global weighted mean/cov in one streaming pass over the loader's
    numpy ``(x, w)`` chunks, on ``device``."""
    s = s2 = None
    cnt = 0.0
    for x, w in loader():
        x = torch.as_tensor(x, device=device)
        w = torch.as_tensor(w, device=device)
        xw = x * w[:, None]
        c0 = torch.sum(x * xw, dim=0)
        c1 = torch.sum(xw, dim=0)
        s = c1 if s is None else s + c1
        s2 = c0 if s2 is None else s2 + c0
        cnt += float(torch.sum(w))
    mean = s / max(cnt, 1e-30)
    return mean, s2 / max(cnt, 1e-30) - mean * mean


def train_model_streaming(generator: torch.Generator, loader,
                          init: GmmDiag, cfg: TrainCfg,
                          stats_fn=None, chunk: int = 4096,
                          verbose: bool = False) -> GmmDiag:
    """UBM EM over a corpus streamed in bounded buffers.

    ``loader`` is a zero-argument callable returning a fresh iterable of
    numpy ``(x, w)`` fixed-shape chunks per epoch (the
    featureServerBufferSize contract).  Each chunk goes to the init
    model's device; each EM iteration streams the corpus once and merges
    the per-chunk stats, so the result equals in-RAM training when the
    bagged masks match."""
    if stats_fn is None:
        stats_fn = default_stats_fn(chunk=chunk)
    dev = init.device
    _, gcov = streaming_global_mean_cov(loader, dev)
    gmm = init
    k, d = init.means.shape
    for it in range(cfg.nb_train_it):
        floor = schedule_value(cfg.init_variance_flooring,
                               cfg.final_variance_flooring,
                               cfg.nb_train_it, it)
        ceil = schedule_value(cfg.init_variance_ceiling,
                              cfg.final_variance_ceiling,
                              cfg.nb_train_it, it)
        merged = EmStats.zeros(k, d, device=dev)
        for x, w in loader():
            w = torch.as_tensor(w, device=dev)
            mask = bagged_frame_mask(generator, w,
                                     cfg.bagged_frame_probability,
                                     cfg.bagged_minimal_length,
                                     cfg.bagged_maximal_length)
            merged = merged.merge(stats_fn(torch.as_tensor(x, device=dev),
                                           mask, gmm))
        if verbose:
            print(f"stream it {it}: meanLLK={float(merged.mean_llk()):.5f} "
                  f"frames={float(merged.count):.0f}")
        gmm = _m_step_with_variance_control(merged, floor, ceil, gcov)
    if cfg.component_reduction and cfg.target_distrib_count > 0:
        gmm = reduce_model(gmm, cfg.target_distrib_count)
    return gmm
