"""Diagonal-GMM log-densities, posteriors and EM sufficient stats — the
plain PyTorch path (port of lia_ral_tpu/gmm/kernels.py).

The per-frame × per-component Gaussian log-likelihood is two matmuls via
the quadratic expansion

    −½ Σ_d (x_d−μ_kd)²·ivar_kd
        = −½·(x² @ ivarᵀ) + x @ (μ·ivar)ᵀ − ½·Σ_d μ²·ivar ,

and the EM stats are γᵀ@X / γᵀ@X².  These functions are what the CUDA
kernels of ``cuda_kernels`` are held against, and what runs for tensors
on the CPU.  Every function takes an explicit per-frame weight vector:
0 marks padding, unselected labels and bagged-out frames.
"""

from __future__ import annotations

import dataclasses

import torch

from .model import GmmDiag


@dataclasses.dataclass(frozen=True)
class EmStats:
    """Zero/first/second-order sufficient statistics plus the LLK monitor
    (ALIZE MixtureGDStat EM accumulators).  ``merge`` is associative."""

    n: torch.Tensor          # (K,)   Σ_t γ_tk·w_t
    sum_x: torch.Tensor      # (K,D)  Σ_t γ_tk·w_t·x_t
    sum_xx: torch.Tensor     # (K,D)  Σ_t γ_tk·w_t·x_t²
    llk: torch.Tensor        # ()     Σ_t w_t·log p(x_t)
    count: torch.Tensor      # ()     Σ_t w_t

    @classmethod
    def zeros(cls, k: int, d: int, dtype=torch.float32,
              device=None) -> "EmStats":
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(n=z(k), sum_x=z(k, d), sum_xx=z(k, d), llk=z(), count=z())

    @classmethod
    def stack(cls, rows: list["EmStats"]) -> "EmStats":
        """Several rows' stats with a leading row axis."""
        return cls(*(torch.stack(f) for f in zip(
            *(dataclasses.astuple(r) for r in rows))))

    def merge(self, other: "EmStats") -> "EmStats":
        return EmStats(*(a + b for a, b in zip(
            dataclasses.astuple(self), dataclasses.astuple(other))))

    def mean_llk(self) -> torch.Tensor:
        """Reference getMeanLLK: average frame log-likelihood."""
        return self.llk / torch.clamp(self.count, min=1e-30)

    def to(self, device) -> "EmStats":
        return EmStats(*(a.to(device) for a in dataclasses.astuple(self)))


def component_logdens(x: torch.Tensor, gmm: GmmDiag) -> torch.Tensor:
    """Per-frame per-component Gaussian log-density (N,K)."""
    mi = gmm.means * gmm.cov_inv                               # (K,D)
    cst = gmm.log_const() - 0.5 * torch.sum(gmm.means * mi, dim=-1)
    quad = (x * x) @ gmm.cov_inv.T                             # (N,K)
    cross = x @ mi.T
    return -0.5 * quad + cross + cst[None, :]


def weighted_logdens(x: torch.Tensor, gmm: GmmDiag) -> torch.Tensor:
    """log(w_k · N_k(x)) — (N,K)."""
    return component_logdens(x, gmm) + gmm.log_weights()[None, :]


def frame_llk(x: torch.Tensor, gmm: GmmDiag, min_llk: float | None = None,
              max_llk: float | None = None) -> torch.Tensor:
    """Per-frame GMM log-likelihood (N,), optionally clamped to the
    reference's [minLLK, maxLLK] bounds."""
    llk = torch.logsumexp(weighted_logdens(x, gmm), dim=-1)
    if min_llk is not None:
        llk = torch.clamp(llk, min=min_llk)
    if max_llk is not None:
        llk = torch.clamp(llk, max=max_llk)
    return llk


def llk_and_posteriors(x: torch.Tensor, gmm: GmmDiag
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(llk (N,), posteriors γ (N,K)) in one pass."""
    lw = weighted_logdens(x, gmm)
    llk = torch.logsumexp(lw, dim=-1)
    return llk, torch.exp(lw - llk[:, None])


def em_stats(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag) -> EmStats:
    """Sufficient statistics of one frame block: x (N,D), w (N,)."""
    llk, post = llk_and_posteriors(x, gmm)
    pw = post * w[:, None]                                     # (N,K)
    return EmStats(n=torch.sum(pw, dim=0), sum_x=pw.T @ x,
                   sum_xx=pw.T @ (x * x), llk=torch.sum(llk * w),
                   count=torch.sum(w))


def em_stats_chunked(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                     chunk: int = 4096) -> EmStats:
    """Stats over a long frame axis, ``chunk`` frames at a time, so the
    (chunk, K) posterior block bounds the memory instead of (N, K)."""
    acc = EmStats.zeros(gmm.n_components, gmm.dim, x.dtype, x.device)
    for s in range(0, x.shape[0], chunk):
        acc = acc.merge(em_stats(x[s:s + chunk], w[s:s + chunk], gmm))
    return acc
