"""Plain reference of total-variability (T-matrix) training: Dehak,
Kenny, Dehak, Dumouchel and Ouellet, "Front-End Factor Analysis for
Speaker Verification", IEEE TASLP 19(4), 2011, whose EM follows Kenny's
eigenvoice estimation (Kenny, Boulianne and Dumouchel, "Eigenvoice
modeling with sparse training data", IEEE TSAP 13(3), 2005) with every
session treated as a speaker of its own; LIA_RAL runs it as the tool
TotalVariability.

Plain ``torch`` in the dtype of the caller's tensors: float64 for the
reference, float32 where a control runs it in a lower precision.  TF32 is
set off on import, so a float32 product is a float32 product unless a
caller turns TF32 on around a call.  Imports nothing of the program and
no JAX.

Shapes: K components of dimension D, rank R; T is (R, K, D) (its rows
are the R supervector directions, component-major), the UBM's means and
variances (K, D); a session's zero-order statistics n (K,) and first-
order statistics f (K, D), raw (not centred).

What it holds, from the published equations:

* ``precisions``: E_c = T_c Σ_c⁻¹ T_cᵀ of every component, (K, R, R);
* ``posteriors``: for each session, L_s = I + Σ_c n_sc E_c, the
  posterior covariance L_s⁻¹ (``torch.linalg.inv``) and mean
  w_s = L_s⁻¹ Σ_c T_c Σ_c⁻¹ F̄_sc with F̄_sc = f_sc − n_sc m_c;
* ``accumulate``: over every session, a block at a time,
  A_c = Σ_s n_sc (L_s⁻¹ + w_s w_sᵀ), C_c = Σ_s w_s F̄_scᵀ (R, D),
  Σ_s (L_s⁻¹ + w_s w_sᵀ), Σ_s w_s and the number of sessions;
* ``m_step``: T_c = A_c⁻¹ C_c (``torch.linalg.solve``);
* ``min_divergence``: with μ = Σ w / S and
  Σ_w = Σ E[wwᵀ] / S − μμᵀ, the means move to m + Tᵀμ and T to LᵀT,
  L the lower Cholesky factor of Σ_w, so that the prior of the new
  i-vectors is N(0, I) again;
* ``em_iteration``: the three in turn.

Departures from the paper, each shared with the port it is held against:

* minimum divergence in LIA_RAL's order (minDivergence): the means move
  with the T of the M-step, before the rotation;
* a session with no frames (n = 0) counts in S, with L = I and w = 0, as
  in LIA_RAL's loop over the session list;
* the UBM's weights and covariances stay fixed (the paper's T training
  updates neither).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def precisions(t: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """E_c = T_c Σ_c⁻¹ T_cᵀ: T (R, K, D), variances (K, D) → (K, R, R)."""
    return torch.einsum("rkd,kd,qkd->krq", t, 1.0 / var, t)


def posteriors(n: torch.Tensor, f: torch.Tensor, t: torch.Tensor,
               means: torch.Tensor, var: torch.Tensor,
               e: torch.Tensor | None = None):
    """(w (B, R), L⁻¹ (B, R, R), F̄ (B, K, D)) of a block of sessions:
    n (B, K), f (B, K, D)."""
    r = t.shape[0]
    if e is None:
        e = precisions(t, var)
    fbar = f - n[..., None] * means
    eye = torch.eye(r, dtype=t.dtype, device=t.device)
    l_mat = eye + torch.einsum("bk,krq->brq", n, e)
    b = torch.einsum("rkd,kd,bkd->br", t, 1.0 / var, fbar)
    l_inv = torch.linalg.inv(l_mat)
    w = torch.einsum("brq,bq->br", l_inv, b)
    return w, l_inv, fbar


def accumulate(n: torch.Tensor, f: torch.Tensor, t: torch.Tensor,
               means: torch.Tensor, var: torch.Tensor, block: int = 64
               ) -> dict:
    """The E-step's accumulators over all S sessions, ``block`` sessions
    at a time: ``a`` (K, R, R), ``c`` (K, R, D), ``r_mat`` (R, R),
    ``r_vec`` (R,), ``sessions`` (S) and each session's ``w`` (S, R).
    The statistics may be of another dtype or device than T; each block
    is brought to T's."""
    r, k, d = t.shape
    dt, dev = t.dtype, t.device
    e = precisions(t, var)
    acc = {"a": torch.zeros(k, r, r, dtype=dt, device=dev),
           "c": torch.zeros(k, r, d, dtype=dt, device=dev),
           "r_mat": torch.zeros(r, r, dtype=dt, device=dev),
           "r_vec": torch.zeros(r, dtype=dt, device=dev),
           "sessions": n.shape[0]}
    ws = []
    for s0 in range(0, n.shape[0], block):
        nb = n[s0:s0 + block].to(dev, dt)
        fb = f[s0:s0 + block].to(dev, dt)
        w, l_inv, fbar = posteriors(nb, fb, t, means, var, e)
        second = l_inv + w[:, :, None] * w[:, None, :]     # E[wwᵀ]
        acc["a"] += torch.einsum("bk,brq->krq", nb, second)
        acc["c"] += torch.einsum("br,bkd->krd", w, fbar)
        acc["r_mat"] += second.sum(0)
        acc["r_vec"] += w.sum(0)
        ws.append(w)
    acc["w"] = torch.cat(ws)
    return acc


def m_step(acc: dict) -> torch.Tensor:
    """T_c = A_c⁻¹ C_c, returned as (R, K, D)."""
    return torch.linalg.solve(acc["a"], acc["c"]).permute(1, 0, 2)


def min_divergence(t: torch.Tensor, means: torch.Tensor, acc: dict):
    """(T, means) of the minimum-divergence step: means + Tᵀμ, then LᵀT
    with Σ_w = L Lᵀ."""
    s = max(acc["sessions"], 1)
    mu = acc["r_vec"] / s
    cov = acc["r_mat"] / s - torch.outer(mu, mu)
    new_means = means + torch.einsum("r,rkd->kd", mu, t)
    chol = torch.linalg.cholesky(cov)
    return torch.einsum("rq,rkd->qkd", chol, t), new_means


def em_iteration(n, f, t, means, var, block: int = 64,
                 min_div: bool = True):
    """One EM iteration from (T, means): (T', means', w (S, R))."""
    acc = accumulate(n, f, t, means, var, block)
    t_new = m_step(acc)
    if min_div:
        t_new, means = min_divergence(t_new, means, acc)
    return t_new, means, acc["w"]
