"""Order-3 polynomial feature expansion (GLDS kernel; port of
lia_ral_tpu/utils/polyexp.py).

Equivalent of reference ``LIA_Utils/PolyExp`` (PolyExpand.cpp:65-83):
expansion = all degree-≤3 monomials with repetition over [1, f], in the
reference's exact i≤j≤k ordering; size (D+3)(D+2)(D+1)/6 (11,480 columns
a frame at D=39).
"""

from __future__ import annotations

import numpy as np
import torch


def poly_expansion_size(d: int) -> int:
    return (d + 3) * (d + 2) * (d + 1) // 6


def _index_triples(d: int) -> np.ndarray:
    base = d + 1
    out = []
    for i in range(base):
        for j in range(i, base):
            for k in range(j, base):
                out.append((i, j, k))
    return np.asarray(out, np.int32)


def poly_expand(x: torch.Tensor) -> torch.Tensor:
    """x (N, D) → (N, (D+3)(D+2)(D+1)/6) monomial expansion, batched, on
    x's device.

    The reference writes the expansion in place over [1, f]
    (PolyExpand.cpp:73-80); that is value-preserving, so this batched
    product over the original [1, f] equals the reference output element
    for element, in its exact i≤j≤k order.  The products are taken left
    to right, (a_i·a_j)·a_k, as in the JAX package.
    """
    n, d = x.shape
    aug = torch.cat([torch.ones((n, 1), dtype=x.dtype, device=x.device), x],
                    dim=1)                                       # (N, D+1)
    trip = torch.as_tensor(_index_triples(d), dtype=torch.long,
                           device=x.device)
    return aug[:, trip[:, 0]] * aug[:, trip[:, 1]] * aug[:, trip[:, 2]]


def glds_expand_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Average expansion over selected frames — the GLDS supervector
    (reference computeAndAccumulateExpansion, PolyExpand.cpp:85-116)."""
    e = poly_expand(x)
    return (torch.sum(e * w[:, None], dim=0)
            / torch.clamp(torch.sum(w), min=1e-30))
