"""Parameters of the JAX package (as numpy arrays) → port state, and back.

The JAX package is never imported here: a caller turns a JAX GmmDiag,
TvModel, TvAccums, EmStats or BwStats into numpy (``np.asarray`` on each
field) and passes the arrays in, so both packages compute from identical
values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fa.stats import BwStats
from .fa.tv import TvAccums, TvModel
from .gmm.kernels import EmStats
from .gmm.model import GmmDiag


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def gmm_from_numpy(weights, means, cov_inv, device=None) -> GmmDiag:
    return GmmDiag(_t(weights, device), _t(means, device),
                   _t(cov_inv, device))


def gmms_from_numpy(gmms, device=None) -> GmmDiag:
    """Same-shape GMMs, each a (weights, means, cov_inv) triple of arrays,
    as one stacked client GmmDiag with a leading C axis (the layout of
    ``gmm.scoring.stack_gmms``)."""
    w, m, ci = zip(*gmms)
    return gmm_from_numpy(np.stack(w), np.stack(m), np.stack(ci), device)


def tv_from_numpy(t, ubm_means, ubm_inv_var, device=None) -> TvModel:
    return TvModel(_t(t, device), _t(ubm_means, device),
                   _t(ubm_inv_var, device))


def tv_accums_from_numpy(a, c, r_mat, r_vec, n_utts,
                         device=None) -> TvAccums:
    return TvAccums(_t(a, device), _t(c, device), _t(r_mat, device),
                    _t(r_vec, device), _t(n_utts, device))


def em_stats_from_numpy(n, sum_x, sum_xx, llk, count,
                        device=None) -> EmStats:
    return EmStats(_t(n, device), _t(sum_x, device), _t(sum_xx, device),
                   _t(llk, device), _t(count, device))


def bw_stats_from_numpy(n, f, device=None) -> BwStats:
    return BwStats(_t(n, device), _t(f, device))


def to_numpy(obj) -> dict[str, np.ndarray]:
    """Fields of a GmmDiag / TvModel / TvAccums / EmStats / BwStats as
    numpy arrays, keyed by the field names both packages share."""
    if not isinstance(obj, (GmmDiag, TvModel, TvAccums, EmStats, BwStats)):
        raise TypeError(f"to_numpy: unsupported {type(obj).__name__}")
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}
