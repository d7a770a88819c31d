"""Plain reference of exact i-vector extraction (Dehak et al. 2011, eq.
for the posterior mean): w = L⁻¹ T Σ⁻¹ F̄ with L = I + Σ_c n_c T_c Σ_c⁻¹
T_cᵀ and F̄ = F − n·m, solved by Cholesky, in the caller's dtype.
Imports torch only."""

from __future__ import annotations

import torch


def ivectors(n: torch.Tensor, f: torch.Tensor, ubm_means, ubm_var,
             t_mat: torch.Tensor, block: int = 64) -> torch.Tensor:
    """n (S,K), f (S,K,D), T (R,K,D) → i-vectors (S,R)."""
    r, k, d = t_mat.shape
    ivar = 1.0 / ubm_var
    tn = t_mat * ivar[None]                                  # (R,K,D)
    e = torch.einsum("rkd,qkd->krq", tn, t_mat).reshape(k, r * r)
    eye = torch.eye(r, dtype=n.dtype, device=n.device)
    out = []
    for s0 in range(0, n.shape[0], block):
        nb, fb = n[s0:s0 + block], f[s0:s0 + block]
        fbar = fb - nb[..., None] * ubm_means[None]
        l_mat = eye[None] + (nb @ e).reshape(-1, r, r)
        aux = fbar.reshape(fbar.shape[0], -1) @ tn.reshape(r, -1).T
        chol = torch.linalg.cholesky(l_mat)
        out.append(torch.cholesky_solve(aux[..., None], chol)[..., 0])
    return torch.cat(out)
