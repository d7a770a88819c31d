"""Feature normalisation: CMVN (file/segmental/window), feature mapping and
feature warping (port of lia_ral_tpu/frontend/normfeat.py).

Reference ``LIA_SpkDet/NormFeat/NormFeat.cpp`` (normFeat cpp:231 —
file/segmental/window 0-1 normalisation with global fallback
compensation cpp:358-430; Gaussian feature warping cpp:362-368) and
``NormFeatWindowMode.cpp``.  Underlying math: GeneralTools
computeZeroOne (cpp:670-681) and computeWarp (cpp:642-668).

Frames are (..., N, D) tensors with (..., N) selection weights: a
leading batch axis of zero-weight-padded files goes through the same
functions (the ``*_batch`` names).  The sliding-window forms use prefix
sums over the frame axis.
"""

from __future__ import annotations

import torch

from ..gmm.kernels import weighted_logdens
from ..gmm.model import GmmDiag


def _masked_mean_std(x: torch.Tensor, w: torch.Tensor,
                     var_floor: float = 1e-8
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean and std over the frame axis: (..., N, D) → (..., D)."""
    cnt = torch.clamp(torch.sum(w, dim=-1), min=1e-30)[..., None]
    mean = torch.sum(x * w[..., None], dim=-2) / cnt
    var = torch.sum(x * x * w[..., None], dim=-2) / cnt - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=var_floor))


def cmvn_global(x: torch.Tensor, w: torch.Tensor, cms_only: bool = False,
                var_only: bool = False) -> torch.Tensor:
    """File-mode CMVN: 0-mean/1-var over the selected frames (reference
    ``segmentalMode file``); ``cms_only``/``var_only`` mirror the
    reference's cmsOnly / featNormKeepVariance options."""
    mean, std = _masked_mean_std(x, w)
    if cms_only:
        return x - mean[..., None, :]
    if var_only:
        return x / std[..., None, :]
    return (x - mean[..., None, :]) / std[..., None, :]


def cmvn_segmental(x: torch.Tensor, seg_ids: torch.Tensor, w: torch.Tensor,
                   n_segments: int) -> torch.Tensor:
    """Per-segment CMVN: each segment normalised by its own statistics
    (reference ``segmentalMode segment``).  seg_ids: (N,) segment index
    per frame."""
    seg_ids = seg_ids.to(device=x.device, dtype=torch.int64)
    one_hot = torch.nn.functional.one_hot(seg_ids, n_segments).to(x.dtype)
    ow = one_hot * w[:, None]                                   # (N,S)
    cnt = torch.clamp(one_hot.T @ w, min=1e-30)                 # (S,)
    mean = ow.T @ x / cnt[:, None]                              # (S,D)
    ex2 = ow.T @ (x * x) / cnt[:, None]
    std = torch.sqrt(torch.clamp(ex2 - mean * mean, min=1e-8))
    return (x - mean[seg_ids]) / std[seg_ids]


def cmvn_window(x: torch.Tensor, w: torch.Tensor, window: int,
                global_fallback: bool = True) -> torch.Tensor:
    """Sliding-window CMVN: each frame normalised by the statistics of the
    ±window/2 frames around it (reference ``segmentalMode window`` /
    NormFeatWindowMode computeCMVparameters).  ``global_fallback`` pads a
    window with fewer than ``window`` selected frames with the global
    mean/var (NormFeat.cpp:358-430)."""
    half = window // 2
    n = x.shape[-2]
    wx = x * w[..., None]

    def prefix(a, dim):
        zero = torch.zeros_like(a.narrow(dim, 0, 1))
        return torch.cumsum(torch.cat([zero, a], dim=dim), dim=dim)

    cw = prefix(w, -1)                                          # (..., N+1)
    cx = prefix(wx, -2)                                         # (..., N+1, D)
    cxx = prefix(x * wx, -2)
    pos = torch.arange(n, device=x.device)
    lo = torch.clamp(pos - half, 0, n)
    hi = torch.clamp(pos + half + 1, 0, n)
    cnt = cw[..., hi] - cw[..., lo]                             # (..., N)
    sx = cx[..., hi, :] - cx[..., lo, :]
    sxx = cxx[..., hi, :] - cxx[..., lo, :]
    if global_fallback:
        gmean, gstd = _masked_mean_std(x, w)
        deficit = torch.clamp(window - cnt, min=0.0)[..., None]
        sx = sx + deficit * gmean[..., None, :]
        sxx = sxx + deficit * (gstd * gstd + gmean * gmean)[..., None, :]
        cnt = torch.clamp(cnt, min=1e-30) + deficit[..., 0]
    else:
        cnt = torch.clamp(cnt, min=1e-30)
    mean = sx / cnt[..., None]
    var = torch.clamp(sxx / cnt[..., None] - mean * mean, min=1e-8)
    return (x - mean) / torch.sqrt(var)


def feature_mapping(x: torch.Tensor, channel_gmm: GmmDiag,
                    reference_gmm: GmmDiag) -> torch.Tensor:
    """Feature mapping (reference featMap, NormFeat.cpp:583): map each
    frame through its winning component k* of the channel-dependent GMM
    onto the channel-independent reference GMM,
    x' = μ_ref,k* + σ_ref,k*/σ_ch,k* · (x − μ_ch,k*)."""
    k_star = torch.argmax(weighted_logdens(x, channel_gmm), dim=-1)
    mu_ch = channel_gmm.means[k_star]
    mu_ref = reference_gmm.means[k_star]
    # σ_ref/σ_ch = sqrt(covInv_ch / covInv_ref)
    scale = torch.sqrt(channel_gmm.cov_inv[k_star]
                       / reference_gmm.cov_inv[k_star])
    return mu_ref + scale * (x - mu_ch)


def warp_core_prepadded(xp: torch.Tensor, wp: torch.Tensor,
                        window: int = 301, chunk: int = 256) -> torch.Tensor:
    """Warp core over PRE-PADDED signals xp (..., P + 2·half, D): rows
    [half, half+n) are the real frames, the flanks hold the caller's
    reflection padding and anything beyond carries zero weight in wp.
    Returns (..., P, D); only the first n rows are meaningful.

    Per coefficient, the weighted rank of the centre frame within its
    window, p = (rank + ½)/(count + 1), goes through the inverse normal
    CDF (reference computeWarp).  ``chunk`` centre frames at a time bound
    the (chunk, window, D) comparison block.  Window rows past the end
    clamp to the last row, as the JAX gather does."""
    half = window // 2
    rows = xp.shape[-2]
    total = rows - 2 * half                                     # P
    offs = torch.arange(window, device=xp.device)
    outs = []
    for start in range(0, total, chunk):
        idx = start + torch.arange(min(chunk, total - start),
                                   device=xp.device)            # (C,)
        centre = xp[..., torch.clamp(idx + half, max=rows - 1), :]
        win_idx = torch.clamp(idx[:, None] + offs[None, :], max=rows - 1)
        win = xp[..., win_idx, :]                               # (..., C,W,D)
        ww = wp[..., win_idx]                                   # (..., C,W)
        less = (win < centre[..., None, :]).to(xp.dtype)
        rank = torch.sum(less * ww[..., None], dim=-2)          # (..., C,D)
        cnt = torch.clamp(torch.sum(ww, dim=-1), min=1.0)[..., None]
        p = (rank + 0.5) / (cnt + 1.0)
        outs.append(torch.special.ndtri(torch.clamp(p, 1e-6, 1.0 - 1e-6)))
    return torch.cat(outs, dim=-2)


def feature_warping(x: torch.Tensor, w: torch.Tensor, window: int = 301,
                    chunk: int = 256) -> torch.Tensor:
    """Gaussian feature warping over a sliding window of one file, x (N,D)
    (reference featWarp, NormFeat.cpp:661): reflect-pads the edges and
    runs ``warp_core_prepadded``."""
    n, d = x.shape
    half = window // 2
    npad = (-n) % chunk
    xp = torch.cat([torch.flip(x[:half], (0,)), x,
                    torch.flip(x[-half:], (0,)),
                    torch.zeros((npad, d), dtype=x.dtype, device=x.device)])
    wp = torch.cat([torch.flip(w[:half], (0,)), w, torch.flip(w[-half:], (0,)),
                    torch.zeros((npad,), dtype=w.dtype, device=w.device)])
    return warp_core_prepadded(xp, wp, window, chunk)[:n]


# The batch forms over zero-weight-padded files (B,T,D) × (B,T): every
# statistic is weighted by w, so the padding rows change nothing.
cmvn_global_batch = cmvn_global
cmvn_window_batch = cmvn_window
feature_warping_batch = warp_core_prepadded
