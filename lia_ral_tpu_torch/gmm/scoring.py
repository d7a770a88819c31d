"""GMM-UBM trial scoring: LLR with top-K component selection (port of
lia_ral_tpu/gmm/scoring.py).

Reference ``LIA_SpkDet/ComputeTest/ComputeTest.cpp`` (main loop
cpp:90-224): for each test file the world model determines the top-K
components on every ``worldDecime``-th frame (DETERMINE_TOP_DISTRIBS) and
every model — the world too on the other frames — is scored on those
components only, completed by the world's non-top residual mass from the
determine frame (USE_TOP_DISTRIBS; ALIZE LKVector sumNonTopDistribLK).
LLR = client meanLLK − world meanLLK.

The densities are dense matmul products, as in the JAX package: the
(N, K) world block, then all C clients at once as one
(N, D) @ (D, C·K) product per term, and a gather of the top-K columns.
A batch of B test segments scores as one (B, N, C, K) block.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .kernels import weighted_logdens
from .model import GmmDiag


def decime_groups(seg_lengths: list[int], world_decime: int) -> np.ndarray:
    """Group-leader frame index for every frame of a masked frame sequence.

    The reference restarts decimation at each segment (idxFrame counts
    within the segment, ComputeTest.cpp:160); frames in the same group
    share the top-component set determined at the group leader.
    """
    out = []
    base = 0
    for n in seg_lengths:
        idx = np.arange(n)
        out.append(base + (idx // world_decime) * world_decime)
        base += n
    return (np.concatenate(out) if out
            else np.zeros(0, np.int64)).astype(np.int32)


def stack_gmms(gmms: list[GmmDiag]) -> GmmDiag:
    """Same-shape GMMs as one GmmDiag with a leading C axis
    (weights (C,K), means and cov_inv (C,K,D))."""
    return GmmDiag(weights=torch.stack([g.weights for g in gmms]),
                   means=torch.stack([g.means for g in gmms]),
                   cov_inv=torch.stack([g.cov_inv for g in gmms]))


def _stacked_logdens(x: torch.Tensor, clients: GmmDiag) -> torch.Tensor:
    """log(w_ck · N_ck(x)) of stacked clients, x (..., N, D) →
    (..., N, C, K): ``kernels.weighted_logdens`` of every client, its two
    products taken over the flattened (C·K) component axis."""
    c, k, d = clients.means.shape
    flat = GmmDiag(clients.weights.reshape(c * k),
                   clients.means.reshape(c * k, d),
                   clients.cov_inv.reshape(c * k, d))
    return weighted_logdens(x, flat).reshape(*x.shape[:-1], c, k)


def _top_k_batch(x: torch.Tensor, world: GmmDiag, clients: GmmDiag,
                 groups: torch.Tensor, top_k: int, use_residual: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``top_k_llk`` over a batch: x (B,N,D), groups (B,N) → world llk
    (B,N), client llk (B,C,N)."""
    b, n, d = x.shape
    top_k = min(top_k, world.n_components)
    groups = groups.to(device=x.device, dtype=torch.int64)
    wld = weighted_logdens(x.reshape(b * n, d), world).reshape(b, n, -1)
    full_llk = torch.logsumexp(wld, dim=-1)                    # (B,N)
    # top components at the determine frames, gathered per frame (stale
    # sets on the frames of a decimation group)
    top_vals, top_idx = torch.topk(wld, top_k, dim=-1)         # (B,N,k)
    g_k = groups[..., None].expand(b, n, top_k)
    top_vals = torch.gather(top_vals, 1, g_k)
    top_idx = torch.gather(top_idx, 1, g_k)
    det_full = torch.gather(full_llk, 1, groups)
    if use_residual:
        # residual mass of the non-top world components at the determine
        # frame: log(exp(full) − exp(top_lse)), computed stably
        top_lse = torch.logsumexp(top_vals, dim=-1)
        diff = torch.clamp(top_lse - det_full, max=-1e-7)
        residual = det_full + torch.log1p(-torch.exp(diff))    # (B,N)
    else:
        residual = torch.full_like(det_full, -math.inf)

    # world: DETERMINE frames get the full llk, USE frames the top sum
    sel = torch.gather(wld, -1, top_idx)
    approx = torch.logsumexp(torch.cat([sel, residual[..., None]], dim=-1),
                             dim=-1)
    is_det = torch.arange(n, device=x.device)[None, :] == groups
    world_llk = torch.where(is_det, full_llk, approx)

    c = clients.means.shape[0]
    cld = _stacked_logdens(x, clients)                         # (B,N,C,K)
    sel = torch.gather(cld, -1, top_idx[:, :, None, :].expand(b, n, c, top_k))
    res = residual[:, :, None, None].expand(b, n, c, 1)
    client_llk = torch.logsumexp(torch.cat([sel, res], dim=-1), dim=-1)
    return world_llk, client_llk.transpose(1, 2)


def top_k_llk(x: torch.Tensor, world: GmmDiag, clients: GmmDiag,
              groups: torch.Tensor, top_k: int = 10,
              use_residual: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame llk for the world (N,) and the stacked clients (C,N)
    under top-K scoring.  ``groups[t]`` is the frame whose DETERMINE pass
    fixes the top set for frame t (``arange(N)``: every frame
    determines, worldDecime=1)."""
    world_llk, client_llk = _top_k_batch(x[None], world, clients,
                                         torch.as_tensor(groups)[None],
                                         top_k, use_residual)
    return world_llk[0], client_llk[0]


def _mean_llr(world_llk: torch.Tensor, client_llk: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """client meanLLK − world meanLLK over the weighted frames:
    world (B,N), clients (B,C,N), w (B,N) → (B,C)."""
    cnt = torch.clamp(torch.sum(w, dim=-1), min=1e-30)          # (B,)
    mean_w = torch.sum(world_llk * w, dim=-1) / cnt
    mean_c = torch.sum(client_llk * w[:, None, :], dim=-1) / cnt[:, None]
    return mean_c - mean_w[:, None]


def compute_test_llr(x: torch.Tensor, w: torch.Tensor, world: GmmDiag,
                     clients: GmmDiag, groups: torch.Tensor | None = None,
                     top_k: int = 10, use_residual: bool = True
                     ) -> torch.Tensor:
    """File-mode trial LLRs (C,): client meanLLK − world meanLLK over the
    weighted frames (ComputeTest.cpp:197-210)."""
    if groups is None:
        groups = torch.arange(x.shape[0], device=x.device)
    return compute_test_llr_batch(x[None], w[None], world, clients,
                                  torch.as_tensor(groups)[None], top_k,
                                  use_residual)[0]


def compute_test_llr_batch(x: torch.Tensor, w: torch.Tensor,
                           world: GmmDiag, clients: GmmDiag,
                           groups: torch.Tensor, top_k: int = 10,
                           use_residual: bool = True) -> torch.Tensor:
    """Many NDX lines against ONE client set — (B, C) LLRs from padded
    test segments x (B,T,D), frame weights w (B,T) (0 = padding) and
    per-line decimation groups (B,T), as one batched product in place of
    the reference's line-by-line loop (ComputeTest.cpp:90)."""
    world_llk, client_llk = _top_k_batch(x, world, clients, groups, top_k,
                                         use_residual)
    return _mean_llr(world_llk, client_llk, w)


def set_decision(llr, threshold: float) -> torch.Tensor:
    """Reference setDecision (GeneralTools.cpp:232): 1 iff LLR >= thr."""
    return torch.where(torch.as_tensor(llr) >= threshold, 1, 0)


def likelihood_gd(data: GmmDiag, model: GmmDiag, top_data: int | None = None,
                  top_model: int | None = None) -> torch.Tensor:
    """Model-vs-model expected likelihood — reference likelihoodGD
    (GeneralTools.cpp:816-855): for each (top-weight) data component d,
    lk(d) = Σ_m w_m · cst_m · exp(−½ Σ_i (cov_d + Δμ²)/cov_m), and the
    result is Σ_d w_d · log lk(d).  TabWeight component selection
    (GeneralTools.h:153+) = top-N by weight.  The Σ_i contraction is one
    (Kd, Km) matmul of [cov_d + μ_d², μ_d, 1] against the model's
    precision features."""
    kd, km = data.n_components, model.n_components
    top_data = kd if top_data is None else min(top_data, kd)
    top_model = km if top_model is None else min(top_model, km)
    wd, di = torch.topk(data.weights, top_data)
    wm, mi = torch.topk(model.weights, top_model)
    d_mean, d_cov = data.means[di], data.cov[di]             # (kd,D)
    m_mean, m_inv = model.means[mi], model.cov_inv[mi]       # (km,D)
    # Σ_i (cov_d + (μd−μm)²)·inv_m
    #   = (cov_d+μd²)·inv_m − 2 μd·(μm inv_m) + (μm² inv_m)
    a = torch.cat([d_cov + d_mean ** 2, d_mean,
                   torch.ones((top_data, 1), dtype=d_mean.dtype,
                              device=d_mean.device)], dim=-1)
    b = torch.cat([m_inv, -2.0 * m_mean * m_inv,
                   torch.sum(m_mean ** 2 * m_inv, dim=-1, keepdim=True)],
                  dim=-1)
    quad = a @ b.T                                           # (kd,km)
    log_terms = (model.log_const()[mi][None, :] + torch.log(wm)[None, :]
                 - 0.5 * quad)
    lk_comp = torch.logsumexp(log_terms, dim=-1)             # (kd,)
    return torch.sum(wd * lk_comp)
