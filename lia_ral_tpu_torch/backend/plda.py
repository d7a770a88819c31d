"""Gaussian PLDA: x = μ + F·h + G·u + ε,  ε ~ N(0, Σ) (port of
lia_ral_tpu/backend/plda.py).

Equivalent of reference ``PldaModel`` (PldaTools.cpp:2043-2948): initTrain
(cpp:2043), em_iteration (cpp:2329), getExpectedValues (cpp:2346-2789, the
joint (h, u_i) posterior with per-session-count grouping), mStep (cpp:2790,
the [F G] update and minimum divergence), and pldaNativeScoring
(cpp:4489-4610, per-session-count constants and batched bilinear forms).

The reference's per-speaker E-step loop is one batched solve over the
speakers, with the session count n as data; session sums are one-hot
(N,S) products, whose fixed order of summation makes a rerun on the same
device reproduce every digit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.matrix import read_matrix_file, write_matrix_file
from .ivnorm import DevSet, one_hot


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


@dataclasses.dataclass(frozen=True)
class PldaModel:
    mean: torch.Tensor    # (R,)
    f: torch.Tensor       # (R, rankF) eigenvoices
    g: torch.Tensor       # (R, rankG) eigenchannels (rankG may be 0)
    sigma: torch.Tensor   # (R, R) residual covariance (full)

    @property
    def rank_f(self) -> int:
        return self.f.shape[1]

    @property
    def rank_g(self) -> int:
        return self.g.shape[1]

    def within_cov(self) -> torch.Tensor:
        """W̃ = G·Gᵀ + Σ — the effective within-speaker covariance."""
        return self.g @ self.g.T + self.sigma

    def replace(self, **changes) -> "PldaModel":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "PldaModel":
        return PldaModel(*(t.to(device)
                           for t in dataclasses.astuple(self)))

    def save(self, path: str) -> None:
        np.savez(path, **{f.name: getattr(self, f.name).detach().cpu().numpy()
                          for f in dataclasses.fields(self)})

    @classmethod
    def load(cls, path: str, device=None) -> "PldaModel":
        z = np.load(path)
        return cls(*(torch.as_tensor(z[k], dtype=torch.float32, device=device)
                     for k in ("mean", "f", "g", "sigma")))

    # -- reference on-disk format (PldaModel::saveModel, PldaTools.cpp:
    # 2816-2948): five .matx files — mean (R,1), F (R,rankF), G (R,rankG),
    # Sigma (R,R), minDivMean (R,1) ----------------------------------------
    def save_reference(self, mean_path: str, f_path: str, g_path: str,
                       sigma_path: str, min_div_mean_path: str) -> None:
        write_matrix_file(mean_path, _f64(self.mean)[:, None])
        write_matrix_file(f_path, _f64(self.f))
        write_matrix_file(g_path, _f64(self.g))
        write_matrix_file(sigma_path, _f64(self.sigma))
        write_matrix_file(min_div_mean_path, _f64(self.mean)[:, None])

    @classmethod
    def load_reference(cls, mean_path: str, f_path: str, g_path: str | None,
                       sigma_path: str, device=None) -> "PldaModel":
        mean = read_matrix_file(mean_path).ravel()
        f = read_matrix_file(f_path)
        sigma = read_matrix_file(sigma_path)
        g = (read_matrix_file(g_path) if g_path
             else np.zeros((f.shape[0], 0)))
        if g.ndim == 1:
            g = g.reshape(f.shape[0], -1)
        return cls(*(torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in (mean, f, g, sigma)))

    @classmethod
    def init(cls, generator: torch.Generator, dim: int, rank_f: int,
             rank_g: int = 0, data_mean=None, data_cov=None,
             device=None) -> "PldaModel":
        """Random init (reference initTrain, cpp:2043: F/G random, Σ = the
        observed covariance), drawn on the generator's device and moved
        to ``device`` (default: the generator's)."""
        device = generator.device if device is None else device

        def draw(cols):
            return (torch.randn((dim, cols), generator=generator,
                                device=generator.device,
                                dtype=torch.float32) * 0.1).to(device)

        f, g = draw(rank_f), draw(rank_g)
        mean = (torch.zeros(dim, device=device) if data_mean is None
                else torch.as_tensor(data_mean, dtype=torch.float32,
                                     device=device))
        sigma = (torch.eye(dim, device=device) if data_cov is None
                 else torch.as_tensor(data_cov, dtype=torch.float32,
                                      device=device))
        return cls(mean=mean, f=f, g=g, sigma=sigma)


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a matrix that is not positive definite gives
    a factor of NaNs (as ``jnp.linalg.cholesky`` does) instead of an
    exception, so bad input shows as NaN scores and stops no tool."""
    chol, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def plda_em_core(model: PldaModel, x_raw: torch.Tensor,
                 spk_ids: torch.Tensor, n_speakers: int,
                 w: torch.Tensor | None = None, reduce_fn=None) -> PldaModel:
    """One EM iteration over a (possibly local shard of the) session set.

    ``x_raw`` (N,R) session vectors, ``spk_ids`` (N,) speaker index,
    ``w`` (N,) 1/0 session weights (0 = padding row), ``reduce_fn``
    merges cross-session sums across shards (identity when serial; an
    all-reduce when the session axis is split over devices, the shape of
    the reference's threaded getExpectedValues with mutex-guarded
    accumulators, PldaTools.cpp:2647-2664).  The speaker-level solves are
    replicated: they are (S,rf,rf) batched inverses, identical on every
    shard."""
    dev, dt = x_raw.device, x_raw.dtype
    if w is None:
        w = torch.ones(x_raw.shape[0], dtype=dt, device=dev)
    if reduce_fn is None:
        def reduce_fn(v):
            return v

    def eye(n):
        return torch.eye(n, dtype=dt, device=dev)

    x = (x_raw - model.mean[None, :]) * w[:, None]   # pad rows → 0
    r = x.shape[1]
    rf, rg = model.rank_f, model.rank_g
    n_tot = reduce_fn(torch.sum(w))
    inv_sigma = torch.linalg.inv(model.sigma)
    ftw = model.f.T @ inv_sigma                     # (rf, R)
    ftwf = ftw @ model.f
    a = ftwf                                        # (rf, rf)
    if rg:
        gtw = model.g.T @ inv_sigma                 # (rg, R)
        ftwg = ftw @ model.g                        # (rf, rg)
        q = torch.linalg.inv(eye(rg) + gtw @ model.g)
        s = q @ ftwg.T                              # (rg, rf)
        a = ftwf - ftwg @ q @ ftwg.T

    hot = one_hot(spk_ids, n_speakers, dt) * w[:, None]   # (N,S), pads zeroed
    counts = reduce_fn(hot.sum(dim=0))              # (S,)
    fx = x @ ftw.T                                  # (N, rf) per-session f_i
    f_sum = reduce_fn(hot.T @ fx)                   # (S, rf)
    rhs = f_sum
    if rg:
        gx = x @ gtw.T                              # (N, rg)
        g_sum = reduce_fn(hot.T @ gx)               # (S, rg)
        rhs = f_sum - g_sum @ s

    l_mat = eye(rf)[None] + counts[:, None, None] * a[None]   # (S,rf,rf)
    m_cov = torch.linalg.inv(l_mat)                            # (S,rf,rf)
    eh = torch.bmm(m_cov, rhs[:, :, None])[:, :, 0]            # (S,rf)
    eh_per = eh[spk_ids] * w[:, None]                          # (N,rf)
    # joint latent per session y_i = [h_spk; u_i]
    if rg:
        eu = gx @ q.T - eh_per @ s.T                           # (N,rg)
        y = torch.cat([eh_per, eu], dim=1)                     # (N, rf+rg)
    else:
        y = eh_per
    # second-moment accumulators: E[y yᵀ] = cov + E[y]E[y]ᵀ
    ehh = reduce_fn(y.T @ y)
    # covariance blocks (reference tmpM, cpp:2460-2470): per session,
    # through the per-speaker counts, so no (N,rf,rf) gather is needed
    cov_hh = torch.einsum("s,sij->ij", counts, m_cov)          # (rf,rf)
    if rg:
        msum_t = cov_hh @ s.T                                  # (rf,rg)
        cov_uu = n_tot * q + s @ msum_t
        cov = torch.cat([torch.cat([cov_hh, -msum_t], dim=1),
                         torch.cat([-msum_t.T, cov_uu], dim=1)], dim=0)
    else:
        cov = cov_hh
    ehh_sum = ehh + cov                                        # (rf+rg)²
    xh_sum = reduce_fn(x.T @ y)                                # (R, rf+rg)

    # M-step: [F G] = xhSum · EhhSum⁻¹ (reference mStep cpp:2790-2815)
    fg = torch.linalg.solve(ehh_sum.T, xh_sum.T).T             # (R, rf+rg)
    f_new, g_new = fg[:, :rf], fg[:, rf:]
    sigma_obs = reduce_fn(x.T @ x) / n_tot
    sigma_new = sigma_obs - (fg @ xh_sum.T) / n_tot
    sigma_new = 0.5 * (sigma_new + sigma_new.T) + 1e-6 * eye(r)
    # minimum divergence on h: whiten by the posterior second moment of h
    hh = (eh.T @ eh + torch.sum(m_cov, dim=0)) / n_speakers
    f_new = f_new @ _cholesky(hh + 1e-9 * eye(rf))
    if rg:
        uu = (reduce_fn(eu.T @ eu) + cov_uu) / n_tot
        g_new = g_new @ _cholesky(uu + 1e-9 * eye(rg))
    # mean update (reference _Delta): fold the residual data mean back in
    mean_new = model.mean + reduce_fn(torch.sum(x, dim=0)) / n_tot
    return PldaModel(mean=mean_new, f=f_new, g=g_new, sigma=sigma_new)


def plda_em_iteration(model: PldaModel, dev: DevSet) -> PldaModel:
    """One EM iteration (reference em_iteration cpp:2329-2344 +
    getExpectedValues + mStep)."""
    return plda_em_core(model, dev.vectors, dev.spk_ids, dev.n_speakers)


def plda_train(generator: torch.Generator | None, dev: DevSet, rank_f: int,
               rank_g: int = 0, n_iterations: int = 10,
               verbose: bool = False,
               init: PldaModel | None = None, mesh=None) -> PldaModel:
    """Full trainer (reference PLDA.cpp:74-99: center → EM loop → save).
    ``init`` warm-starts EM from a loaded model (pldaLoadInitMatrices);
    without it F and G are drawn from ``generator``.  ``mesh`` shards the
    session axis of each EM iteration over its "data" axis (the threaded
    getExpectedValues, PldaTools.cpp:2647)."""
    x = dev.vectors
    if init is not None:
        model = init.to(x.device)
    else:
        mean = torch.mean(x, dim=0)
        xc = x - mean[None, :]
        model = PldaModel.init(generator, x.shape[1], rank_f, rank_g,
                               data_mean=mean, data_cov=(xc.T @ xc)
                               / x.shape[0], device=x.device)
    for it in range(n_iterations):
        if mesh is not None:
            from ..parallel.sharding import sharded_plda_em_iteration
            model = sharded_plda_em_iteration(mesh, model, dev)
        else:
            model = plda_em_iteration(model, dev)
        if verbose:
            print(f"PLDA EM it {it}: |F|={float(model.f.abs().mean()):.5f} "
                  f"tr(Sigma)={float(torch.trace(model.sigma)):.4f}")
    return model


def _gaussian_logpdf_terms(cov: torch.Tensor):
    """(inverse, logdet) of a covariance."""
    chol = _cholesky(cov)
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return torch.cholesky_solve(eye, chol), logdet


def plda_llr(model: PldaModel, enroll: torch.Tensor,
             n_sessions: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """Batched PLDA verification LLR (reference pldaNativeScoring,
    cpp:4489-4610).

    enroll: (M, R) per-model MEAN of its enrollment i-vectors;
    n_sessions: (M,) number of enrollment sessions per model;
    test: (T, R).  Returns (M, T) scores.

    LLR(m, t) = log N(t; F·ĥ_m, F·C_m·Fᵀ + W̃) − log N(t; 0, F·Fᵀ + W̃)
    with ĥ_m, C_m the h-posterior given the m's sessions: the reference's
    per-#session constants K_L appear here as the n-dependent (C_m-based)
    covariance terms, batched over models.  The function holds a
    (M, R, R) covariance block and a (M, T, R) difference block.
    """
    w_cov = model.within_cov()
    rf = model.rank_f
    w_inv, _ = _gaussian_logpdf_terms(w_cov)
    p = model.f.T @ w_inv                         # (rf, R)
    a = p @ model.f                               # (rf, rf)
    xe = enroll - model.mean[None, :]
    xt = test - model.mean[None, :]
    # h posterior per model: L_m = I + n_m·A ; ĥ = L⁻¹·n·P·x̄
    eye_f = torch.eye(rf, dtype=a.dtype, device=a.device)
    l_mat = eye_f[None] + n_sessions[:, None, None] * a[None]
    f_stat = n_sessions[:, None] * (xe @ p.T)     # (M, rf)
    h_hat = torch.linalg.solve(l_mat, f_stat[..., None])[..., 0]
    c_m = torch.linalg.inv(l_mat)                 # (M, rf, rf)
    mu_t = h_hat @ model.f.T                      # (M, R) predicted test mean

    # same-speaker covariance per model: F·C_m·Fᵀ + W̃, depending on n only
    # through C_m
    cov_same = model.f[None] @ c_m @ model.f.T[None] + w_cov[None]
    chol_same = _cholesky(cov_same)
    logdet_same = 2.0 * torch.sum(torch.log(
        torch.diagonal(chol_same, dim1=1, dim2=2)), dim=1)     # (M,)
    # quadratic form per (m, t): (t−μ_m)ᵀ cov_same⁻¹ (t−μ_m)
    diff = xt[None, :, :] - mu_t[:, None, :]      # (M, T, R)
    sol = torch.cholesky_solve(diff.transpose(1, 2), chol_same)  # (M, R, T)
    quad_same = torch.sum(diff * sol.transpose(1, 2), dim=-1)    # (M, T)

    cov_diff = model.f @ model.f.T + w_cov
    inv_diff, logdet_diff = _gaussian_logpdf_terms(cov_diff)
    quad_diff = torch.sum((xt @ inv_diff) * xt, dim=-1)          # (T,)
    return 0.5 * (quad_diff[None, :] - quad_same
                  + logdet_diff - logdet_same[:, None])
