"""Joint Factor Analysis engine: M_{s,h} = m + V·y_s + U·x_h + D·z_s (port
of lia_ral_tpu/fa/jfa.py).

Equivalent of reference ``AccumulateJFAStat`` as its tools drive it:

* EigenVoice (EigenVoice.cpp:71-163): iterate {estimateVEVT,
  estimateAndInverseL_EV, substractMplusDZ, substractUX, estimateYandV,
  updateVestimate, orthonormalizeV};
* EigenChannel (EigenChannel.cpp:70-200): Y with V fixed, then iterate
  {estimateUEUT, estimateAndInverseL_EC, substractMplusVYplusDZ,
  estimateXandU};
* EstimateDMatrix (EstimateDMatrix.cpp:105-212): MAP-like per-speaker
  residual with relevance factor (estimateZMAP,
  AccumulateJFAStat.cpp:3576);
* speaker-model synthesis getSpeakerModel = m + V·y + U·x + D·z
  (AccumulateJFAStat.cpp:4605).

Subspaces are (R, K, D) tensors, as the TotalVariability matrix; the
per-entity L-solves are batched Cholesky factorisations and the
accumulators flattened matrix products.  Session↔speaker bookkeeping
(reference JFATranslate) is an integer index tensor; sessions are summed
into speakers by a one-hot product, whose order of summation is fixed.

Memory at K=2048, D=39: the Gram block E_c = T_c Σ_c⁻¹ T_cᵀ is (K, R, R)
floats, and the accumulator A has the same size; one of each is live at
a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..backend.ivnorm import one_hot
from ..gmm.kernels import frame_llk
from ..gmm.model import GmmDiag
from .stats import BwStats


@dataclasses.dataclass(frozen=True)
class JfaModel:
    v: torch.Tensor            # (Rv, K, D) eigenvoices
    u: torch.Tensor            # (Ru, K, D) eigenchannels
    d: torch.Tensor            # (K, D)    diagonal residual
    ubm_means: torch.Tensor    # (K, D)
    ubm_inv_var: torch.Tensor  # (K, D)

    @property
    def rank_v(self) -> int:
        return self.v.shape[0]

    @property
    def rank_u(self) -> int:
        return self.u.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ubm_means.device

    def replace(self, **changes) -> "JfaModel":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "JfaModel":
        return JfaModel(*(t.to(device) for t in dataclasses.astuple(self)))

    @classmethod
    def init(cls, generator: torch.Generator, rank_v: int, rank_u: int,
             gmm: GmmDiag, scale: float = 0.001) -> "JfaModel":
        """Random Gaussian init of V and U, D zeroed (reference
        initEV/initEC/initD, AccumulateJFAStat.cpp:1070-1176), drawn on
        the generator's device and moved to the GMM's."""
        k, d = gmm.means.shape

        def draw(rank):
            return (torch.randn((rank, k, d), generator=generator,
                                device=generator.device,
                                dtype=torch.float32) * scale).to(gmm.device)

        v = draw(rank_v)
        return cls(v=v, u=draw(rank_u),
                   d=torch.zeros((k, d), dtype=torch.float32,
                                 device=gmm.device),
                   ubm_means=gmm.means.to(torch.float32),
                   ubm_inv_var=gmm.cov_inv.to(torch.float32))

    def supervector(self, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor
                    ) -> torch.Tensor:
        """m + V·y + U·x + D·z — (K, D) means of one session (reference
        getSpeakerModel, cpp:4605)."""
        return (self.ubm_means + _offsets(y[None], self.v)[0]
                + _offsets(x[None], self.u)[0] + self.d * z)

    def speaker_gmm(self, y: torch.Tensor, z: torch.Tensor,
                    weights: torch.Tensor) -> GmmDiag:
        means = self.ubm_means + _offsets(y[None], self.v)[0] + self.d * z
        return GmmDiag(weights=weights, means=means,
                       cov_inv=self.ubm_inv_var)


@dataclasses.dataclass(frozen=True)
class JfaStats:
    """Per-speaker and per-session Baum-Welch stats (reference _statN,
    _statF / _statN_h, _statF_X_h) + session→speaker index."""

    spk: BwStats               # n (S,K), f (S,K,D)
    sess: BwStats              # n (H,K), f (H,K,D)
    sess_spk: torch.Tensor     # (H,) int64

    @classmethod
    def from_sessions(cls, sess: BwStats, sess_spk, n_speakers: int
                      ) -> "JfaStats":
        """Aggregate session stats into speaker stats (the reference
        stacks them at accumulation time, cpp:501-691)."""
        if not isinstance(sess_spk, torch.Tensor):
            sess_spk = torch.from_numpy(np.asarray(sess_spk, np.int64))
        sess_spk = sess_spk.to(device=sess.n.device, dtype=torch.int64)
        hot = one_hot(sess_spk, n_speakers, sess.n.dtype)         # (H,S)
        return cls(spk=BwStats(n=hot.T @ sess.n,
                               f=_sum_sessions(hot, sess.f)),
                   sess=sess, sess_spk=sess_spk)

    def to(self, device) -> "JfaStats":
        return JfaStats(self.spk.to(device), self.sess.to(device),
                        self.sess_spk.to(device))


def _sum_sessions(hot: torch.Tensor, per_session: torch.Tensor
                  ) -> torch.Tensor:
    """Σ_{h∈s} of a (H,K,D) block through the one-hot (H,S) → (S,K,D)."""
    h, k, d = per_session.shape
    return (hot.T @ per_session.reshape(h, k * d)).reshape(-1, k, d)


def _offsets(latent: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """T·latent per entity: (B,R) through a (R,K,D) subspace → (B,K,D)."""
    r, k, d = t.shape
    return (latent @ t.reshape(r, k * d)).reshape(-1, k, d)


def _subspace_gram(t: torch.Tensor, inv_var: torch.Tensor) -> torch.Tensor:
    """E_c = T_c Σ_c⁻¹ T_cᵀ — (K, R, R) (reference estimateVEVT/UEUT,
    cpp:1255/1415)."""
    tn = t * inv_var[None]                                     # (R,K,D)
    return torch.bmm(tn.permute(1, 0, 2), t.permute(1, 2, 0))


def _latent_posterior(t: torch.Tensor, inv_var: torch.Tensor,
                      gram: torch.Tensor, n: torch.Tensor,
                      fbar: torch.Tensor):
    """Posterior of a latent with prior N(0,I) through subspace ``t``.

    n (B,K), fbar (B,K,D) residual first-order stats.
    Returns (mean (B,R), cov=L⁻¹ (B,R,R)) — reference
    estimateAndInverseL_EV/_EC (cpp:1959/2127).
    """
    r, k, d = t.shape
    b = n.shape[0]
    eye = torch.eye(r, dtype=n.dtype, device=n.device)
    l_mat = eye[None] + (n @ gram.reshape(k, r * r)).reshape(b, r, r)
    aux = fbar.reshape(b, k * d) @ (t * inv_var[None]).reshape(r, k * d).T
    chol = torch.linalg.cholesky(l_mat)
    mean = torch.cholesky_solve(aux[..., None], chol)[..., 0]
    cov = torch.cholesky_solve(eye.expand_as(l_mat), chol)
    return mean, cov


def _center(stats: BwStats, model: JfaModel) -> torch.Tensor:
    """F − N·m (reference substractM equivalent)."""
    return stats.f - stats.n[..., None] * model.ubm_means[None]


def _subtract(fbar: torch.Tensor, n: torch.Tensor, offset: torch.Tensor
              ) -> torch.Tensor:
    """F̄ − N·offset for a per-entity (B,K,D) mean offset (reference
    substractMplusDZ / substractUX / substractMplusVYplusDZ family,
    cpp:3795/4142/4390)."""
    return fbar - n[..., None] * offset


def _speaker_ux_stats(stats: JfaStats, model: JfaModel, x: torch.Tensor,
                      n_speakers: int) -> torch.Tensor:
    """Σ_{h∈s} N_h·(U·x_h) — the channel part to remove from SPEAKER
    stats (reference substractUX, cpp:4142)."""
    contrib = stats.sess.n[..., None] * _offsets(x, model.u)    # (H,K,D)
    hot = one_hot(stats.sess_spk, n_speakers, contrib.dtype)
    return _sum_sessions(hot, contrib)


# -- latent estimation --------------------------------------------------------

def v_residual(stats: JfaStats, model: JfaModel, x: torch.Tensor,
               z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Speaker-level (n, F̄) residual for the V substep: F̄ centered,
    minus D·z and the per-speaker channel stats (substractMplusDZ +
    substractUX, cpp:3795/4142)."""
    s = stats.spk.n.shape[0]
    fbar = _center(stats.spk, model)
    fbar = _subtract(fbar, stats.spk.n, model.d[None] * z)
    fbar = fbar - _speaker_ux_stats(stats, model, x, s)
    return stats.spk.n, fbar


def u_residual(stats: JfaStats, model: JfaModel, y: torch.Tensor,
               z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Session-level (n, F̄) residual for the U substep
    (substractMplusVYplusDZ, cpp:4390)."""
    spk_off = _offsets(y, model.v) + model.d[None] * z           # (S,K,D)
    fbar = _center(stats.sess, model)
    fbar = _subtract(fbar, stats.sess.n, spk_off[stats.sess_spk])
    return stats.sess.n, fbar


def estimate_y(stats: JfaStats, model: JfaModel, x: torch.Tensor,
               z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Speaker factors y given channel factors x and residual z
    (reference estimateY, cpp:2857).  Returns (y (S,Rv), cov (S,Rv,Rv))."""
    n, fbar = v_residual(stats, model, x, z)
    gram = _subspace_gram(model.v, model.ubm_inv_var)
    return _latent_posterior(model.v, model.ubm_inv_var, gram, n, fbar)


def estimate_x(stats: JfaStats, model: JfaModel, y: torch.Tensor,
               z: torch.Tensor, gram: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel factors x per session given y and z (reference estimateX,
    cpp:3252).  ``gram``: the U Gram block ``_subspace_gram(model.u,
    model.ubm_inv_var)`` when the caller holds it (a per-file loop builds
    it once); the result is the same."""
    n, fbar = u_residual(stats, model, y, z)
    if gram is None:
        gram = _subspace_gram(model.u, model.ubm_inv_var)
    return _latent_posterior(model.u, model.ubm_inv_var, gram, n, fbar)


def _z_map(model: JfaModel, n: torch.Tensor, fbar: torch.Tensor,
           tau: float) -> tuple[torch.Tensor, torch.Tensor]:
    """MAP mean of z from the residual stats, and the posterior precision
    τ + N·d²Σ⁻¹ per (s,k,d)."""
    den = tau + n[..., None] * (model.d[None] ** 2 * model.ubm_inv_var[None])
    return model.d[None] * model.ubm_inv_var[None] * fbar / den, den


def _d_residual(stats: JfaStats, model: JfaModel, y: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Speaker-level F̄ minus V·y and the per-speaker channel stats."""
    fbar = _center(stats.spk, model)
    fbar = _subtract(fbar, stats.spk.n, _offsets(y, model.v))
    return fbar - _speaker_ux_stats(stats, model, x, stats.spk.n.shape[0])


def estimate_z_map(stats: JfaStats, model: JfaModel, y: torch.Tensor,
                   x: torch.Tensor, tau: float = 10.0) -> torch.Tensor:
    """MAP residual z per speaker with relevance factor τ (reference
    estimateZMAP, cpp:3576): z = D·Σ⁻¹·F̃ / (τ + N·D²Σ⁻¹) elementwise per
    (k,d)."""
    return _z_map(model, stats.spk.n, _d_residual(stats, model, y, x),
                  tau)[0]


def estimate_yx_joint(stats: JfaStats, model: JfaModel, z: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint (y, x) posterior per SPEAKER over the stacked [V; U]
    subspace — reference estimateVUEVUT (AccumulateJFAStat.cpp:1573, the
    Gram of the concatenated subspace) + estimateAndInverseL_VU
    (cpp:2289) + estimateYX/splitYX (cpp:3518/3772), the enrollment path
    of TrainTargetJFA (TrainTarget.cpp:521-536).  In this mode the
    channel factor is tied per speaker (_YX is (n_speakers, Rv+Ru)): all
    of a speaker's enrollment sessions share one x.

    Returns (y (S,Rv), x_spk (S,Ru), joint posterior cov (S,Rv+Ru,Rv+Ru)).
    """
    rv = model.rank_v
    vu = torch.cat([model.v, model.u], dim=0)                 # (Rv+Ru,K,D)
    gram = _subspace_gram(vu, model.ubm_inv_var)
    fbar = _center(stats.spk, model)
    fbar = _subtract(fbar, stats.spk.n, model.d[None] * z)    # substractMplusDZ
    yx, cov = _latent_posterior(vu, model.ubm_inv_var, gram,
                                stats.spk.n, fbar)
    return yx[:, :rv], yx[:, rv:], cov


def estimate_z_joint(stats: JfaStats, model: JfaModel, y: torch.Tensor,
                     x_spk: torch.Tensor, tau: float = 10.0) -> torch.Tensor:
    """MAP residual z per speaker AFTER a joint (y, x) estimate —
    reference substractMplusVUYX + estimateZ (TrainTarget.cpp:538-541):
    the channel offset here uses the speaker-tied x, not per-session
    factors."""
    offset = _offsets(y, model.v) + _offsets(x_spk, model.u)
    fbar = _subtract(_center(stats.spk, model), stats.spk.n, offset)
    return _z_map(model, stats.spk.n, fbar, tau)[0]


def enroll_targets_joint(stats: JfaStats, model: JfaModel,
                         tau: float = 10.0
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TrainTargetJFA enrollment (TrainTarget.cpp:393-560): one batched
    joint (y, x) estimate over [V; U] followed by the residual z, in
    place of the reference's per-speaker storeAccs/substract/restore
    choreography.  Returns (y (S,Rv), x_spk (S,Ru), z (S,K,D))."""
    z0 = torch.zeros_like(stats.spk.f)
    y, x_spk, _ = estimate_yx_joint(stats, model, z0)
    z = estimate_z_joint(stats, model, y, x_spk, tau)
    return y, x_spk, z


def store_accs(stats: JfaStats) -> JfaStats:
    """Reference storeAccs (AccumulateJFAStat.cpp:3777): snapshot the
    N/F accumulators before the in-place substract* mutations of an EM
    substep.  The port's stats are immutable, so the snapshot is the
    identity; it is kept as API so tool flows mirror the reference's
    storeAccs/restoreAccs pairing (EigenVoice.cpp:117/150)."""
    return stats


def restore_accs(snapshot: JfaStats) -> JfaStats:
    """Reference restoreAccs (AccumulateJFAStat.cpp:3786): the pre-substep
    accumulators.  See store_accs."""
    return snapshot


def save_accs_npz(path: str, stats: JfaStats) -> None:
    """Durable between-substep checkpoint of the full JFA accumulator
    state (sessions + speaker aggregation + index)."""
    def a(t):
        return t.detach().cpu().numpy()
    np.savez(path, spk_n=a(stats.spk.n), spk_f=a(stats.spk.f),
             sess_n=a(stats.sess.n), sess_f=a(stats.sess.f),
             sess_spk=a(stats.sess_spk).astype(np.int32))


def load_accs_npz(path: str, device=None) -> JfaStats:
    z = np.load(path)

    def t(key):
        return torch.as_tensor(z[key], device=device)
    return JfaStats(spk=BwStats(n=t("spk_n"), f=t("spk_f")),
                    sess=BwStats(n=t("sess_n"), f=t("sess_f")),
                    sess_spk=t("sess_spk").to(torch.int64))


def orthonormalize_v(model: JfaModel) -> JfaModel:
    """Row-orthonormalise V in supervector layout — reference
    orthonormalizeV (AccumulateJFAStat.cpp:4700, plain Gram-Schmidt over
    rows of V).  QR on the transpose is the batched equivalent; signs
    are fixed to the Gram-Schmidt convention (positive projection of
    each original row on its orthonormalised self)."""
    flat = model.v.reshape(model.rank_v, -1)                  # (Rv, KD)
    q, r = torch.linalg.qr(flat.T)                            # (KD,Rv)
    sign = torch.sign(torch.diagonal(r))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return model.replace(v=(q * sign[None, :]).T.reshape(model.v.shape)
                         .contiguous())


# -- subspace EM updates ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SubspaceAccums:
    a: torch.Tensor       # (K, R, R)
    c: torch.Tensor       # (R, K, D)

    def merge(self, other: "SubspaceAccums") -> "SubspaceAccums":
        return SubspaceAccums(a=self.a + other.a, c=self.c + other.c)


def _accumulate_subspace(n: torch.Tensor, fbar: torch.Tensor,
                         mean: torch.Tensor, cov: torch.Tensor
                         ) -> SubspaceAccums:
    """A_c = Σ_b N_bc·(cov_b + mean_b·mean_bᵀ); C = Σ_b mean_b ⊗ F̄_b
    (reference estimateYandV / estimateXandU accumulators,
    cpp:2457/3030)."""
    b, k, d = fbar.shape
    r = mean.shape[1]
    second = cov + mean[:, :, None] * mean[:, None, :]
    return SubspaceAccums(
        a=(n.T @ second.reshape(b, r * r)).reshape(k, r, r),
        c=(mean.T @ fbar.reshape(b, k * d)).reshape(r, k, d))


def _solve_subspace(acc: SubspaceAccums) -> torch.Tensor:
    """T_c = A_c⁻¹·C_c per component (reference updateVestimate/
    updateUestimate, cpp:3597/3622)."""
    t_new = torch.linalg.solve(acc.a, acc.c.permute(1, 0, 2))    # (K,R,D)
    return t_new.permute(1, 0, 2).contiguous()


def subspace_em_step(t: torch.Tensor, inv_var: torch.Tensor,
                     n: torch.Tensor, fbar: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared E+M over one subspace given per-entity residual stats:
    posterior latents, A/C accumulators, per-component solve.  Returns
    (new subspace, latent means)."""
    gram = _subspace_gram(t, inv_var)
    mean, cov = _latent_posterior(t, inv_var, gram, n, fbar)
    del gram                        # (K,R,R): free it before A is built
    acc = _accumulate_subspace(n, fbar, mean, cov)
    return _solve_subspace(acc), mean


def jfa_v_iteration(stats: JfaStats, model: JfaModel, x: torch.Tensor,
                    z: torch.Tensor) -> tuple[JfaModel, torch.Tensor]:
    """One EigenVoice EM iteration (EigenVoice.cpp:71-163 loop body).
    Returns (model with new V, y estimates)."""
    n, fbar = v_residual(stats, model, x, z)
    v_new, y = subspace_em_step(model.v, model.ubm_inv_var, n, fbar)
    return model.replace(v=v_new), y


def jfa_u_iteration(stats: JfaStats, model: JfaModel, y: torch.Tensor,
                    z: torch.Tensor) -> tuple[JfaModel, torch.Tensor]:
    """One EigenChannel EM iteration (EigenChannel.cpp:70-200 loop body)."""
    n, fbar = u_residual(stats, model, y, z)
    u_new, x = subspace_em_step(model.u, model.ubm_inv_var, n, fbar)
    return model.replace(u=u_new), x


def jfa_d_iteration(stats: JfaStats, model: JfaModel, y: torch.Tensor,
                    x: torch.Tensor, tau: float = 10.0
                    ) -> tuple[JfaModel, torch.Tensor]:
    """D estimation given V (and U) — reference EstimateDMatrix.cpp:105-212:
    ML update of the diagonal from the speaker residual with the MAP-τ
    posterior for z."""
    fbar = _d_residual(stats, model, y, x)
    z_mean, den = _z_map(model, stats.spk.n, fbar, tau)
    # M-step: d_kd = Σ_s z·F̄ / Σ_s N·E[z²], with E[z²] = mean² + 1/den
    num = torch.sum(z_mean * fbar, dim=0)
    ezz = z_mean * z_mean + 1.0 / den
    den_m = torch.sum(stats.spk.n[..., None] * ezz, dim=0)
    return model.replace(d=num / torch.clamp(den_m, min=1e-10)), z_mean


def jfa_train(generator: torch.Generator, stats: JfaStats, gmm: GmmDiag,
              rank_v: int, rank_u: int,
              nb_it_v: int = 10, nb_it_u: int = 10, nb_it_d: int = 0,
              tau: float = 10.0, verbose: bool = False
              ) -> tuple[JfaModel, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full JFA training: V then U then D (the reference's tool order:
    EigenVoice → EigenChannel → EstimateDMatrix)."""
    model = JfaModel.init(generator, rank_v, rank_u, gmm)
    dev = stats.spk.n.device
    s = stats.spk.n.shape[0]
    h = stats.sess.n.shape[0]
    x = torch.zeros((h, rank_u), device=dev)
    z = torch.zeros((s,) + tuple(gmm.means.shape), device=dev)
    y = torch.zeros((s, rank_v), device=dev)
    for it in range(nb_it_v):
        model, y = jfa_v_iteration(stats, model, x, z)
        if verbose:
            print(f"JFA V it {it}: |V|={float(model.v.abs().mean()):.5f}")
    for it in range(nb_it_u):
        y, _ = estimate_y(stats, model, x, z)
        model, x = jfa_u_iteration(stats, model, y, z)
        if verbose:
            print(f"JFA U it {it}: |U|={float(model.u.abs().mean()):.5f}")
    for it in range(nb_it_d):
        y, _ = estimate_y(stats, model, x, z)
        x, _ = estimate_x(stats, model, y, z)
        model, z = jfa_d_iteration(stats, model, y, x, tau)
        if verbose:
            print(f"JFA D it {it}: |D|={float(model.d.abs().mean()):.5f}")
    y, _ = estimate_y(stats, model, x, z)
    x, _ = estimate_x(stats, model, y, z)
    if nb_it_d > 0:
        z = estimate_z_map(stats, model, y, x, tau)
    return model, y, x, z


def jfa_verify_em_llk(x_frames: torch.Tensor, mask: torch.Tensor,
                      stats: JfaStats, model: JfaModel,
                      weights: torch.Tensor, y: torch.Tensor,
                      x: torch.Tensor, z: torch.Tensor,
                      max_sessions: int = 1) -> float:
    """EM-likelihood monitor (reference JFAAcc::getLLK / verifyEMLK,
    AccumulateJFAStat.cpp:4803-4860): total mean frame LLK of up to
    ``max_sessions`` sessions under their synthesised session models
    m + V·y + U·x + D·z — rises over V/U/D EM iterations.

    x_frames (H, T, Dim) padded session frames with (H, T) mask."""
    total = 0.0
    for h in range(min(max_sessions, int(stats.sess.n.shape[0]))):
        spk = int(stats.sess_spk[h])
        sess_gmm = GmmDiag(weights=weights,
                           means=model.supervector(y[spk], x[h], z[spk]),
                           cov_inv=model.ubm_inv_var)
        llk = frame_llk(x_frames[h], sess_gmm)
        total += float(torch.sum(llk * mask[h])
                       / torch.clamp(torch.sum(mask[h]), min=1.0))
    return total


# -- scoring ------------------------------------------------------------------

def jfa_dot_product_scores(stats_test: BwStats, model: JfaModel,
                           y_models: torch.Tensor, x_test: torch.Tensor,
                           z_models: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Linear (dot-product) JFA scoring — reference ComputeTestDotProduct
    (ComputeTest.cpp:228): score(m, t) = <V·y_m [+D·z_m], Σ⁻¹·(F̄_t −
    N_t·U·x_t)> normalised by the test frame count."""
    fbar = stats_test.f - stats_test.n[..., None] * model.ubm_means[None]
    fbar = fbar - stats_test.n[..., None] * _offsets(x_test, model.u)
    fnorm = fbar * model.ubm_inv_var[None]                    # (T,K,D)
    sv = _offsets(y_models, model.v)
    if z_models is not None:
        sv = sv + model.d[None] * z_models
    frames = torch.clamp(torch.sum(stats_test.n, dim=-1), min=1e-6)  # (T,)
    m, t = sv.shape[0], fnorm.shape[0]
    return (sv.reshape(m, -1) @ fnorm.reshape(t, -1).T) / frames[None, :]
