"""Score normalisation: z-norm, t-norm, zt-norm, tz-norm (port of
lia_ral_tpu/backend/norm.py).

Reference ``LIA_SpkDet/ComputeNorm`` (ComputeNorm.cpp:491-765;
Norm/DistribNorm classes cpp:96-365): per-entity impostor score
distributions normalise the trial scores of an (M models × T segments)
score matrix; ``tools/compute_norm.py`` adapts NIST score files to it.

Statistics follow ``DistribNorm::computeMeanStd`` (cpp:121-159): mean and
biased std (``meanMode 0``) or median and mean absolute deviation
(``meanMode 1``), after dropping the highest ``percentH`` and lowest
``percentL`` fraction of each impostor distribution (cpp:127-135).
"""

from __future__ import annotations

import math

import torch


def _median(scores: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.median``: the middle element, or the mean of the two middle
    ones for an even count (``torch.median`` would return the lower)."""
    srt = torch.sort(scores, dim=axis).values
    n = srt.shape[axis]
    lo = srt.select(axis, (n - 1) // 2)
    hi = srt.select(axis, n // 2)
    return (lo + hi) * 0.5


def _stats(scores: torch.Tensor, axis: int, use_median: bool = False,
           percent_h: float = 0.0, percent_l: float = 0.0,
           mask: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-entity location/scale of impostor scores along ``axis``.

    ``mask`` (same shape, 1 = trial present) takes RAGGED impostor
    distributions: the reference keeps per-entity score lists of varying
    length, so a sparse trial matrix is reduced per entity over its
    present scores only, never filled.  Trim counts and the median index
    are then per-entity ranks, and the median is the lower-median element
    of the kept list."""
    if mask is None:
        n = scores.shape[axis]
        if percent_h or percent_l:
            discard_h = int(n * percent_h)
            discard_l = int(n * percent_l)
            srt = torch.sort(scores, dim=axis, descending=True).values
            scores = srt.narrow(axis, discard_h, n - discard_h - discard_l)
        if use_median:
            # meanMode 1: location = median, scale = mean absolute
            # deviation (cpp:147-151)
            mu = _median(scores, axis)
            sd = torch.mean(torch.abs(scores - mu.unsqueeze(axis)), dim=axis)
        else:
            mu = torch.mean(scores, dim=axis)
            sd = torch.std(scores, dim=axis, correction=0)   # biased
        return mu, torch.clamp(sd, min=1e-12)

    s = torch.movedim(scores, axis, -1)
    m = torch.movedim(mask, axis, -1).to(torch.float32)
    s = torch.where(m > 0, s, 0.0)    # absent trials may carry a NaN fill
    # sort descending with absent trials pushed to the end; stable, so
    # tied scores keep their order under the percentile trim
    key = torch.where(m > 0, s, -math.inf)
    order = torch.argsort(-key, dim=-1, stable=True)
    ss = torch.gather(s, -1, order)
    ms = torch.gather(m, -1, order)
    cnt = torch.sum(ms, dim=-1, keepdim=True)
    rank = torch.cumsum(ms, dim=-1) - ms           # rank among present
    dh = torch.floor(cnt * percent_h)
    dl = torch.floor(cnt * percent_l)
    keep = (ms > 0) & (rank >= dh) & (rank < cnt - dl)
    kf = keep.to(torch.float32)
    ncnt = torch.clamp(torch.sum(kf, dim=-1), min=1.0)
    if use_median:
        med_rank = dh[..., 0] + torch.floor((ncnt - 1.0) / 2.0)
        is_med = (rank == med_rank[..., None]) & keep
        mu = torch.sum(torch.where(is_med, ss, 0.0), dim=-1)
        sd = torch.sum(torch.abs(ss - mu[..., None]) * kf, dim=-1) / ncnt
    else:
        mu = torch.sum(ss * kf, dim=-1) / ncnt
        ex2 = torch.sum(ss * ss * kf, dim=-1) / ncnt
        sd = torch.sqrt(torch.clamp(ex2 - mu * mu, min=0.0))
    return mu, torch.clamp(sd, min=1e-12)


def znorm(scores: torch.Tensor, impostor_seg_scores: torch.Tensor,
          use_median: bool = False, percent_h: float = 0.0,
          percent_l: float = 0.0,
          impostor_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Z-norm: normalise per MODEL by its scores against impostor
    segments.  scores (M,T); impostor_seg_scores and impostor_mask
    (M,Z)."""
    mu, sd = _stats(impostor_seg_scores, 1, use_median, percent_h,
                    percent_l, impostor_mask)
    return (scores - mu[:, None]) / sd[:, None]


def tnorm(scores: torch.Tensor, impostor_model_scores: torch.Tensor,
          use_median: bool = False, percent_h: float = 0.0,
          percent_l: float = 0.0,
          impostor_mask: torch.Tensor | None = None) -> torch.Tensor:
    """T-norm: normalise per SEGMENT by impostor-model scores against it.
    scores (M,T); impostor_model_scores and impostor_mask (I,T)."""
    mu, sd = _stats(impostor_model_scores, 0, use_median, percent_h,
                    percent_l, impostor_mask)
    return (scores - mu[None, :]) / sd[None, :]


def ztnorm(scores: torch.Tensor, impostor_seg_scores: torch.Tensor,
           impostor_model_scores: torch.Tensor,
           impostor_cross_scores: torch.Tensor,
           use_median: bool = False, percent_h: float = 0.0,
           percent_l: float = 0.0, z_mask: torch.Tensor | None = None,
           t_mask: torch.Tensor | None = None,
           cross_mask: torch.Tensor | None = None) -> torch.Tensor:
    """ZT-norm: z-norm first, then t-norm with z-normed impostor models
    (reference ztnorm mode, ComputeNorm.cpp:491+).
    impostor_cross_scores (I,Z): impostor models × impostor segments,
    which z-norm the impostor-model rows."""
    kw = dict(use_median=use_median, percent_h=percent_h,
              percent_l=percent_l)
    z = znorm(scores, impostor_seg_scores, impostor_mask=z_mask, **kw)
    z_imp = znorm(impostor_model_scores, impostor_cross_scores,
                  impostor_mask=cross_mask, **kw)
    return tnorm(z, z_imp, impostor_mask=t_mask, **kw)


def tznorm(scores: torch.Tensor, impostor_seg_scores: torch.Tensor,
           impostor_model_scores: torch.Tensor,
           impostor_cross_scores: torch.Tensor,
           use_median: bool = False, percent_h: float = 0.0,
           percent_l: float = 0.0, z_mask: torch.Tensor | None = None,
           t_mask: torch.Tensor | None = None,
           cross_mask: torch.Tensor | None = None) -> torch.Tensor:
    """TZ-norm: t-norm first, then z-norm with t-normed impostor
    segments."""
    kw = dict(use_median=use_median, percent_h=percent_h,
              percent_l=percent_l)
    t = tnorm(scores, impostor_model_scores, impostor_mask=t_mask, **kw)
    t_imp = tnorm(impostor_seg_scores, impostor_cross_scores,
                  impostor_mask=cross_mask, **kw)
    return znorm(t, t_imp, impostor_mask=z_mask, **kw)
