"""Latent Factor Analysis (LFA): the older symmetrical-FA channel model
(port of lia_ral_tpu/fa/lfa.py).

Equivalent of reference ``LIA_SpkTools/FactorAnalysis``
(FactorAnalysis.h:121-211): M_{s,h} = m + D·z_s + U·x_h with D the
relevance-factor diagonal prior (D² = Σ/τ, FactorAnalysis ``_tau``),
channel compensation of models AND features:

* getXEstimate/getYEstimate (h:182-191) → latent posteriors (the
  machinery of fa.jfa);
* substractSpeakerStats/substractChannelStats (h:206-207) → stat
  centering;
* normalizeFeatures (h:210-211) → feature-domain channel compensation
  x_t ← x_t − Σ_g γ_g(t)·(U·x_h)_g, the normFeatLFA path
  (AccumulateJFAStat substractUXfromFeatures cpp:4689 and
  NormFeat.cpp:856).
"""

from __future__ import annotations

import torch

from ..gmm.kernels import llk_and_posteriors
from ..gmm.model import GmmDiag
from .jfa import (JfaModel, JfaStats, _subspace_gram, estimate_x,
                  estimate_z_map, jfa_u_iteration)
from .stats import BwStats


def lfa_model(u: torch.Tensor, gmm: GmmDiag, tau: float = 16.0) -> JfaModel:
    """LFA as a JFA model with V absent and D fixed by the relevance
    factor: D = sqrt(Σ/τ) (reference _tau semantics: a MAP prior with
    relevance τ on the speaker offset).  On the GMM's device."""
    k, d = gmm.means.shape
    cov_inv = gmm.cov_inv.to(torch.float32)
    return JfaModel(
        v=torch.zeros((1, k, d), dtype=torch.float32, device=gmm.device),
        u=torch.as_tensor(u, dtype=torch.float32, device=gmm.device),
        d=torch.sqrt((1.0 / cov_inv) / tau),
        ubm_means=gmm.means.to(torch.float32), ubm_inv_var=cov_inv)


def lfa_train(generator: torch.Generator, stats: JfaStats, gmm: GmmDiag,
              rank_u: int, nb_it: int = 10, tau: float = 16.0,
              verbose: bool = False) -> JfaModel:
    """Train the channel subspace U under the LFA model (reference
    EigenChannel LFA variant, EigenChannel.cpp:70-200 with
    ``channelCompensation LFA``)."""
    k, d = gmm.means.shape
    dev = gmm.device
    s = stats.spk.n.shape[0]
    u0 = torch.randn((rank_u, k, d), generator=generator,
                     device=generator.device, dtype=torch.float32) * 0.001
    model = lfa_model(u0.to(dev), gmm, tau)
    y0 = torch.zeros((s, 1), device=dev)    # no eigenvoice in LFA
    x = torch.zeros((stats.sess.n.shape[0], rank_u), device=dev)
    for it in range(nb_it):
        # z by MAP relevance, y stays zero
        z = estimate_z_map(stats, model, y0, x, tau=tau)
        model, x = jfa_u_iteration(stats, model, y0, z)
        if verbose:
            print(f"LFA U it {it}: |U|={float(model.u.abs().mean()):.6f}")
    return model


def channel_gram(model: JfaModel) -> torch.Tensor:
    """The U Gram block (K, Ru, Ru) that ``estimate_channel`` needs: a
    loop over files builds it once and hands it to every call."""
    return _subspace_gram(model.u, model.ubm_inv_var)


def estimate_channel(stats_session: BwStats, model: JfaModel,
                     gram: torch.Tensor | None = None) -> torch.Tensor:
    """Channel factor x for test sessions with no speaker prior
    (reference getXEstimate): z=0, y=0.  ``gram``: ``channel_gram(model)``
    when the caller holds it; the result is the same."""
    h = stats_session.n.shape[0]
    k, d = model.ubm_means.shape
    dev = stats_session.n.device
    js = JfaStats.from_sessions(stats_session,
                                torch.arange(h, device=dev), h)
    x, _ = estimate_x(js, model, torch.zeros((h, model.rank_v), device=dev),
                      torch.zeros((h, k, d), device=dev), gram=gram)
    return x


def _channel_offset(model: JfaModel, x_h: torch.Tensor) -> torch.Tensor:
    """U·x_h — (K,D)."""
    return torch.einsum("r,rkd->kd", x_h, model.u)


def compensate_features(x: torch.Tensor, gmm: GmmDiag, model: JfaModel,
                        x_h: torch.Tensor) -> torch.Tensor:
    """Feature-domain channel compensation (reference
    substractUXfromFeatures, AccumulateJFAStat.cpp:4689; NormFeat
    normFeatLFA cpp:856): x_t ← x_t − Σ_g γ_g(t)·(U·x_h)_g."""
    _, post = llk_and_posteriors(x, gmm)                # (N,K)
    return x - post @ _channel_offset(model, x_h)


def compensate_model(gmm: GmmDiag, model: JfaModel, x_h: torch.Tensor
                     ) -> GmmDiag:
    """Model-domain compensation: shift means by U·x_h (the
    TrainTargetFA / ComputeTestLFA path, TrainTarget.cpp:279-420)."""
    return gmm.replace(means=gmm.means + _channel_offset(model, x_h))
