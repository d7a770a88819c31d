"""TotalVariability model and exact i-vector extraction (port of
lia_ral_tpu/fa/tv.py, the extraction half).

Reference ``AccumulateTVStat``: estimateTETt (cpp:766) is one batched
product giving E_c = T_c Σ_c⁻¹ T_cᵀ for all components; estimateW
(cpp:2103-2267) solves L_s w_s = T Σ⁻¹ F̄_s per utterance with
L_s = I + Σ_c N_sc E_c, either by batched Cholesky or by conjugate
gradients preconditioned in the eigenbasis of the occupancy-weighted
Σ n̄_c E_c (the reference's eigenDecomposition quantities, used as a
preconditioner so the solve stays exact).

Model layout: T is (R, K, D), the reference's (R, K·D) supervector rows
kept component-major.  The TV E/M-step, minDivergence and the ubmWeight /
eigenDecomposition approximations come in a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..gmm.model import GmmDiag
from .stats import BwStats


@dataclasses.dataclass(frozen=True)
class TvModel:
    t: torch.Tensor            # (R, K, D) total-variability matrix
    ubm_means: torch.Tensor    # (K, D)
    ubm_inv_var: torch.Tensor  # (K, D)

    @property
    def rank(self) -> int:
        return self.t.shape[0]

    @property
    def n_distrib(self) -> int:
        return self.t.shape[1]

    @property
    def dim(self) -> int:
        return self.t.shape[2]

    def t_flat(self) -> torch.Tensor:
        """(R, K·D) supervector layout (reference _T)."""
        return self.t.reshape(self.rank, -1)

    def to(self, device) -> "TvModel":
        return TvModel(self.t.to(device), self.ubm_means.to(device),
                       self.ubm_inv_var.to(device))

    @classmethod
    def from_ubm(cls, t, gmm: GmmDiag) -> "TvModel":
        dev = gmm.device
        return cls(t=torch.as_tensor(t, dtype=torch.float32, device=dev),
                   ubm_means=gmm.means.to(torch.float32),
                   ubm_inv_var=gmm.cov_inv.to(torch.float32))


def init_t(generator: torch.Generator, rank: int, gmm: GmmDiag,
           scale: float = 1.0) -> TvModel:
    """Random Gaussian T init (reference initT, AccumulateTVStat.cpp:701),
    drawn on the generator's device and moved to the GMM's."""
    k, d = gmm.means.shape
    t = torch.randn((rank, k, d), generator=generator,
                    device=generator.device, dtype=torch.float32) * scale
    return TvModel.from_ubm(t.to(gmm.device), gmm)


def _tn_flat(model: TvModel) -> torch.Tensor:
    """T·Σ⁻¹ in (R, K·D) layout."""
    return (model.t * model.ubm_inv_var[None]).reshape(model.rank, -1)


def estimate_tett(model: TvModel) -> torch.Tensor:
    """E_c = T_c Σ_c⁻¹ T_cᵀ for every component — (K, R, R)."""
    tn = model.t * model.ubm_inv_var[None]                 # (R,K,D)
    return torch.bmm(tn.permute(1, 0, 2), model.t.permute(1, 2, 0))


def _l_and_aux(n_blk, fbar_blk, tett, tn_flat):
    """L = I + Σ_c n_c E_c as a (B,K)@(K,R²) product, and
    aux = T Σ⁻¹ F̄ as (B,K·D)@(K·D,R)."""
    b, k = n_blk.shape
    r = tett.shape[1]
    eye = torch.eye(r, dtype=n_blk.dtype, device=n_blk.device)
    l_mat = eye[None] + (n_blk @ tett.reshape(k, r * r)).reshape(b, r, r)
    aux = fbar_blk.reshape(b, -1) @ tn_flat.T
    return l_mat, aux


def _posterior(n_blk, fbar_blk, model: TvModel, tett: torch.Tensor,
               tn_flat: torch.Tensor | None = None, need_cov: bool = True):
    """Per-utterance-block posteriors: (w (B,R), L⁻¹ (B,R,R) or None).
    n_blk: (B,K); fbar_blk: (B,K,D) centered stats."""
    if tn_flat is None:
        tn_flat = _tn_flat(model)
    l_mat, aux = _l_and_aux(n_blk, fbar_blk, tett, tn_flat)
    chol = torch.linalg.cholesky(l_mat)
    w = torch.cholesky_solve(aux[..., None], chol)[..., 0]
    if not need_cov:
        return w, None
    eye = torch.eye(model.rank, dtype=l_mat.dtype, device=l_mat.device)
    return w, torch.cholesky_solve(eye.expand_as(l_mat), chol)


def _posterior_mean(n_blk, fbar_blk, model: TvModel, tett, tn_flat):
    """w only — see _posterior(need_cov=False)."""
    return _posterior(n_blk, fbar_blk, model, tett, tn_flat,
                      need_cov=False)[0]


def _pcg_basis(model: TvModel, n_ref: torch.Tensor):
    """Preconditioner basis: Q = eigenvectors of Σ_k n̄_k·E_k and
    D(k,i) = (Qᵀ E_k Q)_ii, both from the factored E_k = Tn_k·Tn_kᵀ
    (Tn = T·√Σ⁻¹)."""
    r, k, d = model.t.shape
    tn = model.t * torch.sqrt(model.ubm_inv_var)[None]         # (R,K,D)
    nw = n_ref / torch.clamp(torch.sum(n_ref), min=1e-30)
    tns = (tn * torch.sqrt(nw)[None, :, None]).reshape(r, k * d)
    _, q = torch.linalg.eigh(tns @ tns.T)
    h = q.T @ tn.reshape(r, k * d)                              # (R,K·D)
    dk = torch.sum(h.reshape(r, k, d) ** 2, dim=-1).T           # (K,R)
    return q, dk


def _posterior_mean_pcg(n_blk, fbar_blk, model: TvModel, tett, tn_flat,
                        q, dk, iters: int, tol: float = 0.0):
    """w = L⁻¹·aux by conjugate gradients preconditioned with the
    per-utterance diagonal 1/(1 + n·D) in the fixed Q basis.

    ``tol > 0``: stop once EVERY utterance of the block has
    ‖L·x − aux‖ ≤ tol·‖aux‖ (or after ``iters``); ``tol == 0``: exactly
    ``iters`` iterations.  Returns (w (B,R), relative residual (B,))."""
    l_mat, aux = _l_and_aux(n_blk, fbar_blk, tett, tn_flat)
    dinv = 1.0 / (1.0 + n_blk @ dk)

    def m_inv(v):
        return ((v @ q) * dinv) @ q.T

    x = torch.zeros_like(aux)
    res = aux
    p = m_inv(res)
    rz = torch.sum(res * p, dim=1, keepdim=True)
    aux_nrm = torch.clamp(torch.linalg.norm(aux, dim=1), min=1e-30)
    for _ in range(iters):
        if tol > 0.0 and not bool(
                torch.max(torch.linalg.norm(res, dim=1) / aux_nrm) > tol):
            break
        ap = torch.bmm(l_mat, p[..., None])[..., 0]
        alpha = rz / torch.clamp(torch.sum(p * ap, dim=1, keepdim=True),
                                 min=1e-30)
        x = x + alpha * p
        res = res - alpha * ap
        z = m_inv(res)
        rz2 = torch.sum(res * z, dim=1, keepdim=True)
        p = z + (rz2 / torch.clamp(rz, min=1e-30)) * p
        rz = rz2
    return x, torch.linalg.norm(res, dim=1) / aux_nrm


def estimate_w(stats: BwStats, model: TvModel, chunk: int = 256,
               solver: str = "pcg", pcg_iters: int = 16,
               pcg_tol: float = 1e-7, return_diag: bool = False):
    """Exact i-vector extraction: w = L⁻¹ T Σ⁻¹ F̄ per utterance
    (reference estimateW, cpp:2103-2267), ``chunk`` utterances per solve
    block.

    ``solver``: "pcg" (default) or "cholesky".  ``pcg_tol`` > 0 exits the
    CG loop of a block once every utterance of that block reaches that
    relative residual, so an i-vector depends on its block's peers below
    ``pcg_tol``; ``pcg_tol=0`` runs exactly ``pcg_iters`` iterations.
    ``return_diag=True`` also returns the per-utterance relative residual
    ‖L·w − aux‖/‖aux‖ (zeros for Cholesky)."""
    if solver not in ("pcg", "cholesky"):
        raise ValueError(f"unknown estimate_w solver {solver}")
    tett = estimate_tett(model)
    tn_flat = _tn_flat(model)
    fbar = stats.centered(model.ubm_means)
    if solver == "pcg":
        q, dk = _pcg_basis(model, torch.mean(stats.n, dim=0))
    ws, rels = [], []
    for s0 in range(0, stats.n_utts, chunk):
        n_blk, f_blk = stats.n[s0:s0 + chunk], fbar[s0:s0 + chunk]
        if solver == "pcg":
            w_blk, rel = _posterior_mean_pcg(n_blk, f_blk, model, tett,
                                             tn_flat, q, dk, pcg_iters,
                                             pcg_tol)
        else:
            w_blk = _posterior_mean(n_blk, f_blk, model, tett, tn_flat)
            rel = torch.zeros((n_blk.shape[0],), dtype=w_blk.dtype,
                              device=w_blk.device)
        ws.append(w_blk)
        rels.append(rel)
    w = torch.cat(ws)
    if return_diag:
        return w, torch.cat(rels)
    return w
