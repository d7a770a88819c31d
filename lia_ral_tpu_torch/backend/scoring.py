"""i-vector trial scoring (port of lia_ral_tpu/backend/scoring.py, the
cosine part): reference PldaTest cosineDistance (PldaTools.cpp:3842)."""

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
