"""TotalVariability model: T-matrix EM and exact i-vector extraction
(port of lia_ral_tpu/fa/tv.py).

Reference ``AccumulateTVStat``: estimateTETt (cpp:766) is one batched
product giving E_c = T_c Σ_c⁻¹ T_cᵀ for all components; estimateW
(cpp:2103-2267) solves L_s w_s = T Σ⁻¹ F̄_s per utterance with
L_s = I + Σ_c N_sc E_c, either by batched Cholesky or by conjugate
gradients preconditioned in the eigenbasis of the occupancy-weighted
Σ n̄_c E_c (the reference's eigenDecomposition quantities, used as a
preconditioner so the solve stays exact).

estimateAandC (cpp:1691-1800) is ``tv_e_step``, a speaker-chunked loop of
batched Cholesky posteriors; updateTestimate (cpp:974) is ``tv_m_step``,
one batched solve over the component axis; minDivergence (cpp:2056-2101)
whitens T and folds the i-vector mean into the UBM means.

Model layout: T is (R, K, D), the reference's (R, K·D) supervector rows
kept component-major; on disk it is the reference's (R, K·D) .matx.

The two fast approximations of the reference, estimateWUbmWeight
(cpp:2337: one shared weighted covariance scaled per utterance) and
estimateWEigenDecomposition (cpp:2556: L⁻¹ diagonal in a fixed
eigenbasis), and orthonormalizeT (cpp:1548) close the file.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gmm.kernels import frame_llk
from ..gmm.model import GmmDiag
from ..io.matrix import read_matrix_file, write_matrix_file
from ..utils.logging import count, span
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

    def replace(self, **changes) -> "TvModel":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_ubm(cls, t, gmm: GmmDiag) -> "TvModel":
        dev = gmm.device
        return cls(t=torch.as_tensor(t, dtype=torch.float32, device=dev),
                   ubm_means=gmm.means.to(torch.float32),
                   ubm_inv_var=gmm.cov_inv.to(torch.float32))

    # file interop: the reference saves T as (R, K·D) .matx
    def save(self, path: str, fmt: str = "DB") -> None:
        write_matrix_file(path, self.t_flat().detach().cpu().numpy()
                          .astype(np.float64), fmt)

    @classmethod
    def load(cls, path: str, gmm: GmmDiag) -> "TvModel":
        t = read_matrix_file(path)
        k, d = gmm.means.shape
        return cls.from_ubm(t.reshape(t.shape[0], k, d), gmm)


@dataclasses.dataclass(frozen=True)
class TvAccums:
    """EM accumulators (reference _A, _Cmx, _R, _r, _meanW)."""

    a: torch.Tensor        # (K, R, R)  Σ_s N_sc·(L_s⁻¹ + w_s w_sᵀ)
    c: torch.Tensor        # (R, K, D)  Σ_s w_s ⊗ F̄_s
    r_mat: torch.Tensor    # (R, R)     Σ_s (L_s⁻¹ + w_s w_sᵀ)
    r_vec: torch.Tensor    # (R,)       Σ_s w_s
    n_utts: torch.Tensor   # ()

    def merge(self, other: "TvAccums") -> "TvAccums":
        return TvAccums(*(a + b for a, b in zip(
            dataclasses.astuple(self), dataclasses.astuple(other))))

    @classmethod
    def zeros(cls, r: int, k: int, d: int, dtype=torch.float32,
              device=None) -> "TvAccums":
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(a=z(k, r, r), c=z(r, k, d), r_mat=z(r, r), r_vec=z(r),
                   n_utts=z())


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


def tv_e_step(stats: BwStats, model: TvModel, chunk: int = 64
              ) -> tuple[torch.Tensor, TvAccums]:
    """Full E-step over all utterances, ``chunk`` speakers at a time; the
    last chunk is padded with zero-occupancy speakers, which give w = 0
    and are masked out of the accumulators.  Returns (w (S,R), accums).
    Reference estimateAandC (cpp:1691-1800).

    Traced: span ``lia.tv.e_step`` ⊃ one ``lia.tv.e_chunk`` a chunk (its
    posterior and accumulation); counters ``lia.tv.e_chunks``,
    ``lia.tv.e_sessions`` (S) and ``lia.tv.e_pad_sessions`` (the
    padding)."""
    with span("lia.tv.e_step"):
        s, k = stats.n.shape
        d, r = model.dim, model.rank
        dev = stats.n.device
        tett = estimate_tett(model)
        tn_flat = _tn_flat(model)
        fbar = stats.centered(model.ubm_means)              # (S,K,D)
        pad = (-s) % chunk
        count("lia.tv.e_chunks", (s + pad) // chunk)
        count("lia.tv.e_sessions", s)
        count("lia.tv.e_pad_sessions", pad)
        n_p = torch.cat([stats.n, stats.n.new_zeros((pad, k))])
        f_p = torch.cat([fbar, fbar.new_zeros((pad, k, d))])
        valid = torch.cat([torch.ones(s, device=dev),
                           torch.zeros(pad, device=dev)])
        acc = TvAccums.zeros(r, k, d, device=dev)
        ws = []
        for s0 in range(0, s + pad, chunk):
            with span("lia.tv.e_chunk"):
                n_blk, f_blk = n_p[s0:s0 + chunk], f_p[s0:s0 + chunk]
                v_blk = valid[s0:s0 + chunk]
                w, linv = _posterior(n_blk, f_blk, model, tett, tn_flat)
                w = w * v_blk[:, None]                      # zero padding
                cov = ((linv + w[:, :, None] * w[:, None, :])
                       * v_blk[:, None, None])
                acc = TvAccums(
                    a=acc.a + (n_blk.T @ cov.reshape(chunk, r * r)
                               ).reshape(k, r, r),
                    c=acc.c + (w.T @ f_blk.reshape(chunk, k * d)
                               ).reshape(r, k, d),
                    r_mat=acc.r_mat + torch.sum(cov, dim=0),
                    r_vec=acc.r_vec + torch.sum(w, dim=0),
                    n_utts=acc.n_utts + torch.sum(v_blk))
                ws.append(w)
        return torch.cat(ws)[:s], acc


def tv_m_step(model: TvModel, acc: TvAccums) -> TvModel:
    """T_c = A_c⁻¹ C_c per component — reference updateTestimate
    (cpp:974-1005), one batched solve over the component axis (span
    ``lia.tv.m_step``)."""
    with span("lia.tv.m_step"):
        t_new = torch.linalg.solve(acc.a, acc.c.permute(1, 0, 2))  # (K,R,D)
        return model.replace(t=t_new.permute(1, 0, 2).contiguous())


def min_divergence(model: TvModel, acc: TvAccums) -> TvModel:
    """Minimum-divergence step (reference minDivergence, cpp:2056-2101):
    whiten T by the empirical i-vector covariance, fold the i-vector mean
    into the UBM means (span ``lia.tv.min_div``)."""
    with span("lia.tv.min_div"):
        n = torch.clamp(acc.n_utts, min=1.0)
        r_bar = acc.r_vec / n
        r_cov = acc.r_mat / n - r_bar[:, None] * r_bar[None, :]
        # mean update BEFORE rotation (reference order): m += meanWᵀ·T
        new_means = model.ubm_means + torch.einsum("r,rkd->kd", r_bar,
                                                   model.t)
        chol_l = torch.linalg.cholesky(r_cov)               # R = L·Lᵀ
        # T ← Lᵀ·T  (reference Ch upper with R = ChᵀCh, T ← Ch·T)
        t_new = torch.einsum("rq,rkd->qkd", chol_l, model.t)
        return model.replace(t=t_new, ubm_means=new_means)


def tv_em_iteration(stats: BwStats, model: TvModel, chunk: int = 64,
                    min_div: bool = True) -> tuple[TvModel, torch.Tensor]:
    """One full T-matrix EM iteration (reference TotalVariability.cpp
    117-168 loop body; span ``lia.tv.em_iteration`` around the E-step,
    the M-step and the minimum divergence).  Returns (new model,
    i-vectors of this iteration).
    """
    with span("lia.tv.em_iteration"):
        w, acc = tv_e_step(stats, model, chunk=chunk)
        new_model = tv_m_step(model, acc)
        if min_div:
            new_model = min_divergence(new_model, acc)
        return new_model, w


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
    done = 0
    for _ in range(iters):
        if tol > 0.0 and _pcg_converged(res, aux_nrm, tol):
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
        done += 1
    count("lia.tv.pcg_iters", done)
    return x, torch.linalg.norm(res, dim=1) / aux_nrm


def _pcg_converged(res, aux_nrm, tol: float) -> bool:
    """PCG's exit test: one host read of the block's largest relative
    residual (span ``lia.tv.pcg_check``, counter ``lia.tv.host_syncs``)."""
    with span("lia.tv.pcg_check"):
        count("lia.tv.host_syncs")
        return not bool(
            torch.max(torch.linalg.norm(res, dim=1) / aux_nrm) > tol)


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
    ‖L·w − aux‖/‖aux‖ (zeros for Cholesky).

    Traced (``utils.logging``): spans ``lia.tv.basis`` (the PCG basis),
    ``lia.tv.block`` (each solve block), ``lia.tv.pcg_check``; counters
    ``lia.tv.blocks``, ``pcg_iters`` and ``host_syncs``."""
    if solver not in ("pcg", "cholesky"):
        raise ValueError(f"unknown estimate_w solver {solver}")
    with span("lia.fa.estimate_w"):
        tett = estimate_tett(model)
        tn_flat = _tn_flat(model)
        fbar = stats.centered(model.ubm_means)
        if solver == "pcg":
            with span("lia.tv.basis"):
                q, dk = _pcg_basis(model, torch.mean(stats.n, dim=0))
        ws, rels = [], []
        for s0 in range(0, stats.n_utts, chunk):
            with span("lia.tv.block"):
                count("lia.tv.blocks")
                n_blk, f_blk = stats.n[s0:s0 + chunk], fbar[s0:s0 + chunk]
                if solver == "pcg":
                    w_blk, rel = _posterior_mean_pcg(n_blk, f_blk, model,
                                                     tett, tn_flat, q, dk,
                                                     pcg_iters, pcg_tol)
                else:
                    w_blk = _posterior_mean(n_blk, f_blk, model, tett,
                                            tn_flat)
                    rel = torch.zeros((n_blk.shape[0],), dtype=w_blk.dtype,
                                      device=w_blk.device)
            ws.append(w_blk)
            rels.append(rel)
        w = torch.cat(ws)
        if return_diag:
            return w, torch.cat(rels)
        return w


def get_speaker_model(model: TvModel, w: torch.Tensor,
                      gmm: GmmDiag) -> GmmDiag:
    """Synthesise the speaker GMM m + Tᵀw (reference getSpeakerModel,
    AccumulateTVStat.cpp:1533); weights/covariances stay the UBM's."""
    shift = torch.einsum("r,rkd->kd", w, model.t)
    return gmm.replace(means=model.ubm_means + shift)


def verify_em_llk(x: torch.Tensor, mask: torch.Tensor, stats: BwStats,
                  model: TvModel, gmm: GmmDiag, max_utts: int = 1) -> float:
    """EM-likelihood check (reference verifyEMLK / getLLK,
    AccumulateTVStat.cpp:1627-1688, config key ``computeLLK``): total
    mean frame LLK of up to ``max_utts`` utterances (x (S,T,D), mask
    (S,T)) under their synthesised speaker models."""
    w_all = estimate_w(stats, model)
    total = 0.0
    for i in range(min(max_utts, stats.n_utts)):
        spk = get_speaker_model(model, w_all[i], gmm)
        llk = frame_llk(x[i], spk)
        total += float(torch.sum(llk * mask[i])
                       / torch.clamp(torch.sum(mask[i]), min=1.0))
    return total


# -- fast approximations ------------------------------------------------------

def norm_t_matrix(model: TvModel) -> torch.Tensor:
    """T̄ = T·sqrt(Σ⁻¹) (reference normTMatrix, cpp:1600) — (R,K,D)."""
    return model.t * torch.sqrt(model.ubm_inv_var)[None, :, :]


def weighted_cov(model: TvModel, ubm_weights: torch.Tensor) -> torch.Tensor:
    """W = Σ_c w_c·T̄_c T̄_cᵀ (reference getWeightedCov, cpp:2826), as one
    (R,K·D)@(K·D,R) product."""
    tn = norm_t_matrix(model)
    tw = (tn * ubm_weights[None, :, None]).reshape(model.rank, -1)
    return tw @ tn.reshape(model.rank, -1).T


def _normalized_aux(stats: BwStats, model: TvModel) -> torch.Tensor:
    """aux = T̄·(F̄·sqrt(Σ⁻¹)) per utterance — (S,R)."""
    fnorm = stats.normalized(model.ubm_means, model.ubm_inv_var)
    return fnorm.reshape(stats.n_utts, -1) @ norm_t_matrix(model).reshape(
        model.rank, -1).T


def estimate_w_ubm_weight(stats: BwStats, model: TvModel,
                          w_mat: torch.Tensor, chunk: int = 64
                          ) -> torch.Tensor:
    """UBM-weight approximation (reference estimateWUbmWeight, cpp:2337):
    L_s ≈ I + (Σ_c N_sc)·W with W the weighted covariance, one shared R×R
    structure scaled per utterance; ``chunk`` utterances per batched
    Cholesky.  A zero-occupancy utterance has L = I and aux = 0, so
    w = 0."""
    aux = _normalized_aux(stats, model)
    n_sum = torch.sum(stats.n, dim=-1)                            # (S,)
    eye = torch.eye(model.rank, dtype=aux.dtype, device=aux.device)
    ws = []
    for s0 in range(0, stats.n_utts, chunk):
        l_mat = eye[None] + n_sum[s0:s0 + chunk, None, None] * w_mat[None]
        chol = torch.linalg.cholesky(l_mat)
        ws.append(torch.cholesky_solve(aux[s0:s0 + chunk, :, None],
                                       chol)[..., 0])
    return torch.cat(ws)


def eigen_decompose_w(w_mat: torch.Tensor) -> torch.Tensor:
    """Q = eigenvectors of the weighted covariance (reference
    computeEigenProblem, cpp:2999-3104), as columns in ascending order of
    eigenvalue.  Column signs are the eigensolver's."""
    return torch.linalg.eigh(w_mat)[1]


def approximate_tctc(model: TvModel, q: torch.Tensor) -> torch.Tensor:
    """D(c,i) ≈ (Qᵀ T̄_c T̄_cᵀ Q)_ii (reference approximateTcTc, cpp:3106)
    — (K, R); the same whatever the signs of Q's columns."""
    r, k, d = model.t.shape
    tq = q.T @ norm_t_matrix(model).reshape(r, k * d)          # (R,K·D)
    return torch.sum(tq.reshape(r, k, d) ** 2, dim=-1).T       # (K,R)


def estimate_w_eigen_decomposition(stats: BwStats, model: TvModel,
                                   d_mat: torch.Tensor, q: torch.Tensor
                                   ) -> torch.Tensor:
    """Eigen-decomposition approximation (reference
    estimateWEigenDecomposition, cpp:2556-2610): L⁻¹ ≈
    Q·diag(1/(1+N·D))·Qᵀ, no per-utterance factorisation at all."""
    aux = _normalized_aux(stats, model)                        # (S,R)
    inv_l = 1.0 / (1.0 + stats.n @ d_mat)                      # (S,R)
    return ((aux @ q) * inv_l) @ q.T


def orthonormalize_t(model: TvModel) -> TvModel:
    """Orthonormalise the rows of T (reference orthonormalizeT, cpp:1548)
    by QR on the supervector layout.  The row signs are the QR routine's
    (unlike ``fa.jfa.orthonormalize_v``, nothing fixes them)."""
    q, _ = torch.linalg.qr(model.t_flat().T)                   # (K·D,R)
    return model.replace(t=q.T.reshape(model.t.shape).contiguous())
