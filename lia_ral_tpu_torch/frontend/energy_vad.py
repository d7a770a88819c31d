"""Energy-based voice activity detection (port of
lia_ral_tpu/frontend/energy_vad.py).

Reference ``LIA_SpkDet/EnergyDetector`` — energyDetector
(EnergyDetector.cpp:200-280): train a small 1-D GMM on the log-energy
coefficient by EM, pick a threshold from the highest-energy component
(meanStd mode: mean − α·σ, cpp:271-273; weight mode: keep the top-w_high
mass of the energy histogram, computeEnergyThreshold cpp:106-125) and
select the frames above it.  The EM stats pass is kernel K1 (K=3, D=1)
for a CUDA device, its plain version on the CPU; the thresholds are
numpy on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gmm.em import (default_stats_fn, global_mean_cov, m_step,
                      variance_control)
from ..gmm.model import GmmDiag


@dataclasses.dataclass
class EnergyDetectorCfg:
    """Reference EnergyDetector config keys."""

    nb_train_it: int = 10
    mixture_distrib_count: int = 3
    variance_flooring: float = 0.5
    variance_ceiling: float = 10.0
    alpha: float = 0.25
    threshold_mode: str = "meanStd"   # meanStd | weight

    @classmethod
    def from_config(cls, cfg) -> "EnergyDetectorCfg":
        return cls(
            nb_train_it=cfg.get_int("nbTrainIt", 10),
            mixture_distrib_count=cfg.get_int("mixtureDistribCount", 3),
            variance_flooring=cfg.get_float("varianceFlooring", 0.5),
            variance_ceiling=cfg.get_float("varianceCeiling", 10.0),
            alpha=cfg.get_float("alpha", 0.25),
            threshold_mode=cfg.get_str("thresholdMode", "meanStd"),
        )


def energy_mixture_init(k: int, dtype=torch.float32,
                        device=None) -> GmmDiag:
    """Fixed init — reference energyMixtureInit (cpp:173-196): means
    spread linearly over [−2, 2], unit variances, equal weights."""
    if k > 1:
        means = torch.linspace(-2.0, 2.0, k, dtype=dtype,
                               device=device)[:, None]
    else:
        means = torch.full((1, 1), -2.0, dtype=dtype, device=device)
    return GmmDiag(weights=torch.full((k,), 1.0 / k, dtype=dtype,
                                      device=device),
                   means=means,
                   cov_inv=torch.ones((k, 1), dtype=dtype, device=device))


def _likelihood_loss(m1, v1, w1, m2, v2, w2) -> float:
    """Reference likelihoodLoss (EnergyDetector.cpp:~80): symmetrised
    penalty of merging two 1-D Gaussians."""
    a1 = w1 / (w1 + w2)
    a2 = 1.0 - a1
    dm = m1 - m2
    var = a1 * v1 + a2 * v2 + a1 * a2 * dm * dm
    return 0.5 * (w1 * np.log(var / v1) + w2 * np.log(var / v2))


def weight_mode_threshold(energy: np.ndarray, w: np.ndarray,
                          p_select: float, nb_bins: int = 100) -> float:
    """Reference computeEnergyThreshold (cpp:106-125): walk the energy
    histogram from the top until the selected mass reaches p_select."""
    e = energy[w > 0]
    if e.size == 0:
        return -np.inf
    hist, edges = np.histogram(e, bins=nb_bins, density=True)
    count = 0.0
    i = nb_bins - 1
    while i >= 0 and count <= p_select:
        count += hist[i] * (edges[i + 1] - edges[i])
        i -= 1
    return float(edges[i + 2]) if i >= 0 else float(edges[0])


def energy_detector(energy: np.ndarray, w: np.ndarray,
                    cfg: EnergyDetectorCfg, verbose: bool = False,
                    device=None) -> np.ndarray:
    """energy: (N,) log-energy per frame; w: (N,) selection weights; the
    EM runs on ``device``, its stats in the default tier of
    ``em.default_stats_fn``.  Returns the boolean speech mask (True =
    frame above the threshold)."""
    stats_fn = default_stats_fn()
    e = torch.as_tensor(np.asarray(energy, np.float32), device=device)[:, None]
    wt = torch.as_tensor(np.asarray(w, np.float32), device=device)
    _, gcov = global_mean_cov(e, wt)
    gmm = energy_mixture_init(cfg.mixture_distrib_count, device=e.device)
    for it in range(cfg.nb_train_it):
        st = stats_fn(e, wt, gmm)
        gmm = variance_control(m_step(st), cfg.variance_flooring,
                               cfg.variance_ceiling, gcov)
        if verbose:
            print(f"energy EM it {it}: meanLLK={float(st.mean_llk()):.4f}")
    means = gmm.means[:, 0].cpu().numpy()
    covs = (1.0 / gmm.cov_inv)[:, 0].cpu().numpy()
    weights = gmm.weights.cpu().numpy()
    hi = int(np.argmax(means))
    if cfg.threshold_mode == "meanStd":
        threshold = means[hi] - cfg.alpha * np.sqrt(covs[hi])
    elif cfg.threshold_mode == "weight":
        p_select = float(weights[hi])
        if cfg.mixture_distrib_count == 3:
            lo = int(np.argmin(means))
            mid = 3 - hi - lo
            loss_h = _likelihood_loss(means[mid], covs[mid], weights[mid],
                                      means[hi], covs[hi], weights[hi])
            loss_l = _likelihood_loss(means[mid], covs[mid], weights[mid],
                                      means[lo], covs[lo], weights[lo])
            if loss_h < loss_l:
                p_select += cfg.alpha * weights[mid]
        threshold = weight_mode_threshold(np.asarray(energy),
                                          np.asarray(w), p_select)
    else:
        raise ValueError(f"unknown thresholdMode {cfg.threshold_mode}")
    if verbose:
        print(f"energy threshold = {threshold:.4f} "
              f"(mode {cfg.threshold_mode})")
    return (np.asarray(energy) > threshold) & (np.asarray(w) > 0)
