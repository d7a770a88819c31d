"""i-vector trial scoring: cosine, Mahalanobis, two-covariance (port of
lia_ral_tpu/backend/scoring.py).

Equivalent of reference ``PldaTest`` scoring back ends (PldaTools.cpp):
cosineDistance (cpp:3842), mahalanobisDistance, twoCovScoring
(cpp:4083-4180).  Each is a few products over (models × segments); the
reference's BoolMatrix trial mask is applied by the caller.
"""

from __future__ import annotations

import torch


def cosine_scores(models: torch.Tensor, segments: torch.Tensor,
                  wccn: torch.Tensor | None = None) -> torch.Tensor:
    """Cosine similarity (M,T), optionally in WCCN-transformed space."""
    if wccn is not None:
        models = models @ wccn.T
        segments = segments @ wccn.T
    mn = models / torch.clamp(torch.linalg.norm(models, dim=-1,
                                                keepdim=True), min=1e-12)
    sn = segments / torch.clamp(torch.linalg.norm(segments, dim=-1,
                                                  keepdim=True), min=1e-12)
    return mn @ sn.T


def _quad(x: torch.Tensor, metric: torch.Tensor) -> torch.Tensor:
    """xᵀ·M·x per row of x."""
    return torch.sum((x @ metric) * x, dim=-1)


def mahalanobis_scores(models: torch.Tensor, segments: torch.Tensor,
                       metric: torch.Tensor) -> torch.Tensor:
    """−(m−s)ᵀ·M·(m−s) per trial (reference mahalanobisDistance)."""
    cross = models @ metric @ segments.T                    # (M,T)
    return (2.0 * cross - _quad(models, metric)[:, None]
            - _quad(segments, metric)[None, :])


def two_cov_model(w: torch.Tensor, b: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """G' and H' matrices of two-covariance scoring — reference
    twoCovScoring (cpp:4083-4130):
    G' = W⁻¹·(B⁻¹+2W⁻¹)⁻¹·W⁻¹ ; H' = W⁻¹·(B⁻¹+W⁻¹)⁻¹·W⁻¹."""
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    w_inv = torch.linalg.inv(w + 1e-8 * eye)
    b_inv = torch.linalg.inv(b + 1e-8 * eye)
    g = w_inv @ torch.linalg.inv(b_inv + 2.0 * w_inv) @ w_inv
    h = w_inv @ torch.linalg.inv(b_inv + w_inv) @ w_inv
    return g, h


def two_cov_scores(models: torch.Tensor, segments: torch.Tensor,
                   w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-covariance LLR (M,T) — reference twoCovScoring (cpp:4083-4180):
    (m+s)ᵀG'(m+s) − mᵀH'm − sᵀH's (constant terms omitted, as in the
    reference)."""
    g, h = two_cov_model(w, b)
    # (m+s)ᵀG(m+s) = mᵀGm + 2 mᵀGs + sᵀGs
    cross = models @ g @ segments.T                         # (M,T)
    mix = (_quad(models, g)[:, None] + 2.0 * cross
           + _quad(segments, g)[None, :])
    return mix - _quad(models, h)[:, None] - _quad(segments, h)[None, :]
