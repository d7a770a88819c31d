"""MAP adaptation of target models from a world model (port of
lia_ral_tpu/gmm/map_adapt.py).

Reference ``TrainTools.cpp`` MAP stack: computeMAP dispatch
(cpp:541-557), computeMAPConst (cpp:356), computeMAPConst2 (cpp:389),
computeMAPOccDep (cpp:445-490, relevance-factor MAP for mean, variance
and weight), computeMLLR (cpp:788-866) and the adaptModel EM wrapper
(cpp:871-905).  The stats pass of each iteration is kernel K1 for CUDA
tensors, its plain version for CPU ones (``em.default_stats_fn``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .em import bagged_frame_mask, default_stats_fn, m_step
from .kernels import EmStats
from .model import GmmDiag


@dataclasses.dataclass
class MapCfg:
    """Reference MAPCfg (TrainTools.h:74-119), same config keys."""

    # MAPConst | MAPConst2 | MAPOccDep | MAPModelBased | MLLR
    method: str = "MAPOccDep"
    mean_adapt: bool = True
    var_adapt: bool = False
    weight_adapt: bool = False
    mean_r: float = 14.0          # MAPRegFactorMean (or MAPAlphaMean for Const)
    var_r: float = 14.0
    weight_r: float = 14.0
    nb_train_it: int = 1
    bagged_frame_probability: float = 1.0
    bagged_minimal_length: int = 3
    bagged_maximal_length: int = 7

    @classmethod
    def from_config(cls, cfg) -> "MapCfg":
        method = cfg.get_str("MAPAlgo", "MAPOccDep")
        const = method in ("MAPConst", "MAPConst2")
        mean_key = "MAPAlphaMean" if const else "MAPRegFactorMean"
        var_key = "MAPAlphaVar" if const else "MAPRegFactorVar"
        weight_key = "MAPAlphaWeight" if const else "MAPRegFactorWeight"
        return cls(
            method=method,
            mean_adapt=cfg.get_bool("meanAdapt", False),
            var_adapt=cfg.get_bool("varAdapt", False),
            weight_adapt=cfg.get_bool("weightAdapt", False),
            mean_r=cfg.get_float(mean_key, 0.75 if const else 14.0),
            var_r=cfg.get_float(var_key, 0.75 if const else 14.0),
            weight_r=cfg.get_float(weight_key, 0.75 if const else 14.0),
            nb_train_it=cfg.get_int("nbTrainIt", 1),
            bagged_frame_probability=cfg.get_float("baggedFrameProbability",
                                                   1.0),
            bagged_minimal_length=cfg.get_int("baggedMinimalLength", 3),
            bagged_maximal_length=cfg.get_int("baggedMaximalLength", 7),
        )


def map_adapt(world: GmmDiag, em_model: GmmDiag, frame_count: torch.Tensor,
              cfg: MapCfg) -> GmmDiag:
    """One MAP update: combine the world prior with the EM estimate
    ``em_model`` (the M-step on the target data) behind ``frame_count``
    weighted frames."""
    if cfg.method == "MAPConst":
        # mean = α·world + (1−α)·client (cpp:356-383)
        a = cfg.mean_r
        if not cfg.mean_adapt:
            return world
        return world.replace(means=a * world.means
                             + (1.0 - a) * em_model.means)
    if cfg.method == "MAPConst2":
        # weight-weighted constant interpolation (cpp:389-420)
        a = cfg.mean_r
        if not cfg.mean_adapt:
            return world
        wm = a * world.weights[:, None]
        cm = (1.0 - a) * em_model.weights[:, None]
        return world.replace(means=(wm * world.means + cm * em_model.means)
                             / (wm + cm))
    if cfg.method in ("MAPOccDep", "MAPModelBased"):
        # occupancy-dependent relevance-factor MAP (cpp:445-490); an EM
        # estimate with leading axes (and its counts) adapts one model a row
        occ = em_model.weights * frame_count[..., None]       # (..., K)
        out = world
        if cfg.mean_adapt:
            a = (occ / (occ + cfg.mean_r))[..., None]
            out = out.replace(
                means=(1.0 - a) * world.means + a * em_model.means)
        if cfg.var_adapt:
            a = (occ / (occ + cfg.var_r))[..., None]
            dm = world.means - em_model.means
            cov = ((1.0 - a) / world.cov_inv + a / em_model.cov_inv
                   + (1.0 - a) * a * dm * dm)
            out = out.replace(cov_inv=1.0 / cov)
        if cfg.weight_adapt:
            a = occ / (occ + cfg.weight_r)
            w = a * em_model.weights + (1.0 - a) * world.weights
            out = out.replace(weights=w / torch.sum(w, dim=-1, keepdim=True))
        return out
    raise ValueError(f"unknown MAP method {cfg.method}")


def compute_mllr(world: GmmDiag, em_model: GmmDiag,
                 frame_count: torch.Tensor
                 ) -> tuple[GmmDiag, torch.Tensor]:
    """Global MLLR mean transform μ' = W·[1, μ] (reference computeMLLR).
    The per-dimension G-matrix loop is one batched einsum and one batched
    solve over the feature dimension.  Returns (adapted model,
    W (D, D+1))."""
    k, d = world.means.shape
    occ = em_model.weights * frame_count                    # (K,)
    xi = torch.cat([torch.ones((k, 1), dtype=world.means.dtype,
                               device=world.device), world.means], dim=1)
    inv_cov = world.cov_inv                                 # (K,D)
    # Z[p,q] = Σ_j occ_j·μ̂_jp·ξ_jq / cov_jp
    z = torch.einsum("j,jp,jq->pq", occ, em_model.means * inv_cov, xi)
    # G[p] = Σ_j (occ_j/cov_jp)·ξ_j·ξ_jᵀ
    g = torch.einsum("j,jp,jq,jr->pqr", occ, inv_cov, xi, xi)
    g = g + 1e-6 * torch.eye(d + 1, dtype=g.dtype, device=g.device)[None]
    w_mat = torch.linalg.solve(g, z[..., None])[..., 0]     # (D, D+1)
    new_means = w_mat[:, 0][None, :] + world.means @ w_mat[:, 1:].T
    return world.replace(means=new_means), w_mat


def adapt_model(generator: torch.Generator, x: torch.Tensor,
                w: torch.Tensor, world: GmmDiag, cfg: MapCfg,
                chunk: int = 4096,
                stats_fn: Callable[[torch.Tensor, torch.Tensor, GmmDiag],
                                   EmStats] | None = None) -> GmmDiag:
    """Target-model training loop — reference adaptModel: per iteration,
    bagged subsample → EM stats with the current client model → M-step →
    MAP combine with the world prior.

    ``stats_fn(x, w, gmm) -> EmStats`` defaults to the default tier of
    ``em.default_stats_fn`` (the JAX ``adapt_model`` ignores fastStats and
    fastMath): kernel K1 on CUDA tensors, the plain chunked path on CPU
    ones."""
    if stats_fn is None:
        stats_fn = default_stats_fn(chunk=chunk)
    client = world
    for _ in range(cfg.nb_train_it):
        mask = bagged_frame_mask(generator, w, cfg.bagged_frame_probability,
                                 cfg.bagged_minimal_length,
                                 cfg.bagged_maximal_length)
        stats = stats_fn(x, mask, client)
        em_model = m_step(stats)
        if cfg.method == "MLLR":
            client, _ = compute_mllr(world, em_model, stats.count)
        else:
            client = map_adapt(world, em_model, stats.count, cfg)
    return client
