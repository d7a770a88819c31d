"""Shifted delta cepstra (SDC) for language identification (port of
lia_ral_tpu/frontend/sdc.py).

Equivalent of reference ``LIA_SpkDet/ShiftedDeltaFeat``
(ShiftedDeltaFeat.cpp:79): the N-d-P-k parameterisation — from N base
cepstra, compute k delta blocks, each the delta at offset i·P with
spread d, and stack them per frame.
"""

from __future__ import annotations

import torch


def shifted_delta_cepstra(
    x: torch.Tensor,
    n: int = 7,
    d: int = 1,
    p: int = 3,
    k: int = 7,
) -> torch.Tensor:
    """x: (T, C) cepstra with C >= n.  Returns (T, n*k) SDC features.

    Block i (i in [0,k)) at frame t = x[t + i·P + d, :n] − x[t + i·P − d, :n]
    with edge clamping.
    """
    t = x.shape[0]
    base = x[:, :n]

    def shift(offset):
        idx = torch.clamp(torch.arange(t, device=x.device) + offset, 0, t - 1)
        return base[idx]

    blocks = [shift(i * p + d) - shift(i * p - d) for i in range(k)]
    return torch.cat(blocks, dim=-1)
