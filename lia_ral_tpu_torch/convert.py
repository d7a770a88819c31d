"""Parameters of the JAX package (as numpy arrays) → port state, and back.

The JAX package is never imported here: a caller turns a JAX GmmDiag,
TvModel, TvAccums, EmStats, BwStats, DevSet, PldaModel, JfaModel, JfaStats,
SubspaceAccums or DiarHmm into numpy (``np.asarray`` on each field) and passes the
arrays in, so both packages compute from identical values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .backend.ivnorm import DevSet
from .backend.plda import PldaModel
from .fa.jfa import JfaModel, JfaStats, SubspaceAccums
from .fa.stats import BwStats
from .fa.tv import TvAccums, TvModel
from .gmm.kernels import EmStats
from .gmm.model import GmmDiag
from .seg.hmm import DiarHmm


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


def dev_set_from_numpy(vectors, spk_ids, n_speakers: int,
                       device=None) -> DevSet:
    return DevSet(_t(vectors, device),
                  torch.as_tensor(np.array(spk_ids, np.int64), device=device),
                  int(n_speakers))


def plda_from_numpy(mean, f, g, sigma, device=None) -> PldaModel:
    return PldaModel(_t(mean, device), _t(f, device), _t(g, device),
                     _t(sigma, device))


def jfa_from_numpy(v, u, d, ubm_means, ubm_inv_var, device=None) -> JfaModel:
    return JfaModel(_t(v, device), _t(u, device), _t(d, device),
                    _t(ubm_means, device), _t(ubm_inv_var, device))


def jfa_stats_from_numpy(sess_n, sess_f, sess_spk, n_speakers: int,
                         device=None) -> JfaStats:
    """Session stats and the session→speaker index; the speaker stats are
    aggregated here, as ``JfaStats.from_sessions`` does in both
    packages."""
    return JfaStats.from_sessions(bw_stats_from_numpy(sess_n, sess_f, device),
                                  np.asarray(sess_spk), int(n_speakers))


def subspace_accums_from_numpy(a, c, device=None) -> SubspaceAccums:
    return SubspaceAccums(_t(a, device), _t(c, device))


def hmm_from_numpy(weights, means, cov_inv, names, trans,
                   device=None) -> DiarHmm:
    """A DiarHmm from its stacked state bank (weights (S,K), means and
    cov_inv (S,K,D)), the state names and the (S,S) transition
    PROBABILITIES (the log and its 1e-30 floor are taken here, as
    ``DiarHmm.from_gmms`` takes them)."""
    return DiarHmm(gmm_from_numpy(weights, means, cov_inv, device),
                   list(names),
                   torch.log(_t(trans, device) + 1e-30))


_STATE_TYPES = (GmmDiag, TvModel, TvAccums, EmStats, BwStats, PldaModel,
                JfaModel, JfaStats, SubspaceAccums)


def to_numpy(obj) -> dict[str, np.ndarray]:
    """Fields of a port state object (GmmDiag, TvModel, TvAccums, EmStats,
    BwStats, PldaModel, JfaModel, JfaStats, SubspaceAccums, DiarHmm) as
    numpy arrays, keyed by the field names both packages share; a nested
    BwStats (``JfaStats.spk`` / ``.sess``) becomes a dict of its own."""
    if isinstance(obj, DiarHmm):
        return {**to_numpy(obj.gmms), "names": list(obj.names),
                "log_trans": obj.log_trans.detach().cpu().numpy()}
    if not isinstance(obj, _STATE_TYPES):
        raise TypeError(f"to_numpy: unsupported {type(obj).__name__}")
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (to_numpy(v) if isinstance(v, BwStats)
                       else v.detach().cpu().numpy())
    return out
