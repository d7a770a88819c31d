"""PyTorch port vs the JAX package: fa/tv (TvModel, estimate_tett, the
posteriors, exact i-vector extraction with PCG and Cholesky, T-matrix EM,
the ubmWeight and eigenDecomposition approximations, orthonormalize_t),
backend/scoring (cosine), backend/eval and utils/shapes.

Tolerances: i-vectors use the JAX suite's PCG-vs-Cholesky budget
(tests/test_tv.py:242, rtol 2e-5, atol 2e-6) — both are exact f32
solvers, so the two frameworks may differ by f32 roundoff only.  PCG is
compared at the same ``chunk`` on both sides, because its early exit is
decided per chunk (lia_ral_tpu/fa/tv.py:313-324).  E_c products and
posterior covariances: rtol 1e-5, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lia_ral_tpu.backend import eval as jeval
from lia_ral_tpu.backend import scoring as jscoring
from lia_ral_tpu.fa import stats as jstats
from lia_ral_tpu.fa import tv as jtv
from lia_ral_tpu.utils import shapes as jshapes

from lia_ral_tpu_torch import convert
from lia_ral_tpu_torch.backend import eval as teval
from lia_ral_tpu_torch.backend import scoring as tscoring
from lia_ral_tpu_torch.fa import stats as tstats
from lia_ral_tpu_torch.fa import tv as ttv
from lia_ral_tpu_torch.utils import shapes as tshapes

from _torch_parity import (assert_close_scaled, both_gmms, np_of,
                           projector)

W_TOL = dict(rtol=2e-5, atol=2e-6)
MAT_TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, k=16, d=6, r=8, s=21):
    """A random TV model and BW stats, identical in both packages."""
    jg, tg = both_gmms(rng, k, d)
    t = (rng.standard_normal((r, k, d)) * 0.5).astype(np.float32)
    n = (rng.random((s, k)) * 50 + 0.5).astype(np.float32)
    f = (rng.standard_normal((s, k, d)) * 4).astype(np.float32)
    jm = jtv.TvModel.from_ubm(t, jg)
    tm = ttv.TvModel.from_ubm(t, tg)
    js = jstats.BwStats(jnp.asarray(n), jnp.asarray(f))
    ts = convert.bw_stats_from_numpy(n, f)
    return jm, tm, js, ts


def test_tv_model_and_tett_match_jax(rng):
    jm, tm, _, _ = _case(rng)
    assert (tm.rank, tm.n_distrib, tm.dim) == (jm.rank, jm.n_distrib, jm.dim)
    np.testing.assert_array_equal(np_of(tm.t_flat()), np_of(jm.t_flat()))
    np.testing.assert_allclose(np_of(ttv.estimate_tett(tm)),
                               np_of(jtv.estimate_tett(jm)), **MAT_TOL)
    back = convert.to_numpy(tm)
    assert set(back) == {"t", "ubm_means", "ubm_inv_var"}


def test_posterior_with_covariance_matches_jax(rng):
    jm, tm, js, ts = _case(rng, s=6)
    tett_t, tett_j = ttv.estimate_tett(tm), jtv.estimate_tett(jm)
    w_t, linv_t = ttv._posterior(ts.n, ts.centered(tm.ubm_means), tm, tett_t)
    w_j, linv_j = jtv._posterior(js.n, js.centered(jm.ubm_means), jm, tett_j)
    np.testing.assert_allclose(np_of(w_t), np_of(w_j), **W_TOL)
    np.testing.assert_allclose(np_of(linv_t), np_of(linv_j), **MAT_TOL)


@pytest.mark.parametrize("solver,pcg_tol", [("pcg", 0.0), ("pcg", 1e-7),
                                            ("cholesky", 0.0)])
def test_estimate_w_matches_jax(rng, solver, pcg_tol):
    jm, tm, js, ts = _case(rng)
    kw = dict(chunk=8, solver=solver, pcg_tol=pcg_tol)   # ragged last chunk
    w_t, rel_t = ttv.estimate_w(ts, tm, return_diag=True, **kw)
    w_j, rel_j = jtv.estimate_w(js, jm, return_diag=True, **kw)
    np.testing.assert_allclose(np_of(w_t), np_of(w_j), **W_TOL)
    assert rel_t.shape == (21,)
    assert float(rel_t.max()) < 1e-5 and float(np_of(rel_j).max()) < 1e-5
    assert torch.equal(ttv.estimate_w(ts, tm, **kw), w_t)


def test_estimate_w_pcg_equals_cholesky_and_zero_rows(rng):
    _, tm, _, ts = _case(rng)
    w_pcg = ttv.estimate_w(ts, tm, chunk=8)
    w_chol = ttv.estimate_w(ts, tm, chunk=8, solver="cholesky")
    np.testing.assert_allclose(np_of(w_pcg), np_of(w_chol), **W_TOL)
    n0, f0 = ts.n.clone(), ts.f.clone()
    n0[0], f0[0] = 0.0, 0.0
    w0 = ttv.estimate_w(tstats.BwStats(n0, f0), tm)
    assert float(w0[0].abs().max()) < 1e-6
    with pytest.raises(ValueError):
        ttv.estimate_w(ts, tm, solver="lu")


def test_pcg_basis_preconditions_exactly(rng):
    """Q is orthonormal and D(k,i) = (Qᵀ E_k Q)_ii: the same quantities
    as the JAX basis (compared sign-free, through E_k)."""
    jm, tm, _, ts = _case(rng)
    q, dk = ttv._pcg_basis(tm, ts.n.mean(0))
    np.testing.assert_allclose(np_of(q.T @ q), np.eye(tm.rank), atol=1e-5)
    tett = ttv.estimate_tett(tm)
    want = torch.einsum("ri,krq,qi->ki", q, tett, q)
    np.testing.assert_allclose(np_of(dk), np_of(want), **MAT_TOL)
    _, dk_j = jtv._pcg_basis(jm, jnp.asarray(np_of(ts.n.mean(0))))
    # eigenvalues can be ordered alike but signs differ: sort per row
    np.testing.assert_allclose(np.sort(np_of(dk), 1), np.sort(np_of(dk_j), 1),
                               rtol=1e-4, atol=1e-5)


def test_init_t(rng):
    _, tg = both_gmms(rng, 8, 3)
    m1 = ttv.init_t(torch.Generator().manual_seed(0), 5, tg, scale=0.01)
    m2 = ttv.init_t(torch.Generator().manual_seed(0), 5, tg, scale=0.01)
    assert m1.t.shape == (5, 8, 3) and torch.equal(m1.t, m2.t)
    assert 0.005 < float(m1.t.std()) < 0.02
    assert torch.equal(m1.ubm_means, tg.means)
    assert m1.to("cpu").t.device.type == "cpu"


@pytest.mark.parametrize("with_wccn", [False, True])
def test_cosine_scores_match_jax(rng, with_wccn):
    m = rng.standard_normal((4, 6)).astype(np.float32)
    s = rng.standard_normal((7, 6)).astype(np.float32)
    m[1] = 0.0                                    # zero-norm row stays finite
    wc = rng.standard_normal((6, 6)).astype(np.float32) if with_wccn else None
    got = tscoring.cosine_scores(torch.from_numpy(m), torch.from_numpy(s),
                                 None if wc is None else torch.from_numpy(wc))
    want = jscoring.cosine_scores(jnp.asarray(m), jnp.asarray(s),
                                  None if wc is None else jnp.asarray(wc))
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-6)


def test_eval_metrics_match_jax(rng):
    tgt = rng.standard_normal(300) + 1.5
    imp = rng.standard_normal(900)
    for fn in ("eer", "min_dcf"):
        assert getattr(teval, fn)(tgt, imp) == getattr(jeval, fn)(tgt, imp)
    for a, b in zip(teval.det_curve(tgt, imp), jeval.det_curve(tgt, imp)):
        np.testing.assert_array_equal(a, b)
    assert teval.eer(np.array([2.0]), np.array([1.0])) == 0.0


def test_shapes_helpers_match_jax():
    for n in (0, 1, 2, 3, 5, 64, 65, 1000, 2049):
        assert tshapes.next_pow2(n) == jshapes.next_pow2(n)
        assert tshapes.bucket_len(n) == jshapes.bucket_len(n)
        assert tshapes.bucket_len(n, 64) == jshapes.bucket_len(n, 64)
    assert tshapes.FRAME_BUCKET == jshapes.FRAME_BUCKET


# -- T-matrix EM (the training half) -------------------------------------------

ACC_TOL = dict(rtol=1e-4, atol=1e-4)      # accumulators: sums over utterances


def _assert_accums_close(got, want):
    for f in ("a", "c", "r_mat", "r_vec", "n_utts"):
        g, w = np_of(getattr(got, f)), np_of(getattr(want, f))
        np.testing.assert_allclose(g, w, rtol=ACC_TOL["rtol"],
                                   atol=ACC_TOL["atol"] * np.abs(w).max())


@pytest.mark.parametrize("chunk", [4, 21, 64])
def test_tv_e_step_matches_jax(rng, chunk):
    """Chunks that divide S, equal it and exceed it (zero-weight padding
    of the last chunk).  Accumulators: rtol 1e-4, atol 1e-4·max|·| (f32
    sums over 21 utterances of L⁻¹ + wwᵀ)."""
    jm, tm, js, ts = _case(rng)
    w_t, acc_t = ttv.tv_e_step(ts, tm, chunk=chunk)
    w_j, acc_j = jtv.tv_e_step(js, jm, chunk=chunk)
    np.testing.assert_allclose(np_of(w_t), np_of(w_j), **W_TOL)
    _assert_accums_close(acc_t, acc_j)
    assert float(acc_t.n_utts) == 21.0
    back = convert.tv_accums_from_numpy(**{
        f: np.asarray(getattr(acc_j, f)) for f in convert.to_numpy(acc_t)})
    _assert_accums_close(back, acc_j)
    merged = acc_t.merge(ttv.TvAccums.zeros(tm.rank, tm.n_distrib, tm.dim))
    _assert_accums_close(merged, acc_j)


def test_tv_m_step_and_min_divergence_match_jax(rng):
    """Both from the same accumulators (the JAX E-step's, as numpy), so
    only the solve and the whitening are compared: T and means rtol 1e-4,
    atol 1e-5·max|·| (an f32 batched solve)."""
    jm, tm, js, _ = _case(rng)
    _, acc_j = jtv.tv_e_step(js, jm, chunk=8)
    acc_t = convert.tv_accums_from_numpy(**{
        f: np.asarray(getattr(acc_j, f))
        for f in ("a", "c", "r_mat", "r_vec", "n_utts")})
    for t_mod, j_mod in ((ttv.tv_m_step(tm, acc_t), jtv.tv_m_step(jm, acc_j)),
                         (ttv.min_divergence(tm, acc_t),
                          jtv.min_divergence(jm, acc_j))):
        for f in ("t", "ubm_means", "ubm_inv_var"):
            want = np_of(getattr(j_mod, f))
            np.testing.assert_allclose(np_of(getattr(t_mod, f)), want,
                                       rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("min_div", [True, False])
def test_tv_em_iterations_match_jax(rng, min_div):
    """Three EM iterations from the same T: rtol 1e-3, atol
    1e-3·max|·| (chip_smoke.py's i-vector budget), since f32 roundoff of
    the solves compounds over iterations."""
    jm, tm, js, ts = _case(rng)
    for _ in range(3):
        tm, w_t = ttv.tv_em_iteration(ts, tm, chunk=8, min_div=min_div)
        jm, w_j = jtv.tv_em_iteration(js, jm, chunk=8, min_div=min_div)
    for a, b in ((tm.t, jm.t), (tm.ubm_means, jm.ubm_means), (w_t, w_j)):
        b = np_of(b)
        np.testing.assert_allclose(np_of(a), b, rtol=1e-3,
                                   atol=1e-3 * np.abs(b).max())


def test_speaker_model_and_llk_check_match_jax(rng):
    """get_speaker_model (means rtol 1e-5) and the computeLLK check
    (verify_em_llk, rel 1e-5 on a mean frame llk)."""
    from lia_ral_tpu.gmm import GmmDiag as JGmm

    jm, tm, js, ts = _case(rng, k=8, d=4, r=3, s=5)
    w = rng.standard_normal(3).astype(np.float32)
    wg, mg, cg = (rng.random(8) + 0.5).astype(np.float32), \
        np.asarray(jm.ubm_means), np.asarray(jm.ubm_inv_var)
    wg /= wg.sum()
    jg, tg = JGmm.create(wg, mg, cg), convert.gmm_from_numpy(wg, mg, cg)
    spk_t = ttv.get_speaker_model(tm, torch.from_numpy(w), tg)
    spk_j = jtv.get_speaker_model(jm, jnp.asarray(w), jg)
    np.testing.assert_allclose(np_of(spk_t.means), np_of(spk_j.means),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np_of(spk_t.weights), wg)
    x = rng.standard_normal((5, 30, 4)).astype(np.float32)
    mask = (rng.random((5, 30)) > 0.2).astype(np.float32)
    got = ttv.verify_em_llk(torch.from_numpy(x), torch.from_numpy(mask), ts,
                            tm, tg, max_utts=3)
    want = jtv.verify_em_llk(jnp.asarray(x), jnp.asarray(mask), js, jm, jg,
                             max_utts=3)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- the fast approximations (ubmWeight, eigenDecomposition) --------------------

def _ubm_weights(rng, k=16):
    w = (rng.random(k) + 0.5).astype(np.float32)
    return w / w.sum()


def test_weighted_cov_and_norm_t_match_jax(rng):
    """T̄ element-wise (one multiply: 1e-6) and W = Σ_c w_c·T̄_c T̄_cᵀ
    within 1e-5 of scale."""
    jm, tm, _, _ = _case(rng)
    w = _ubm_weights(rng)
    np.testing.assert_allclose(np_of(ttv.norm_t_matrix(tm)),
                               np_of(jtv.norm_t_matrix(jm)), rtol=1e-6,
                               atol=1e-7)
    got = ttv.weighted_cov(tm, torch.from_numpy(w))
    assert_close_scaled(got, jtv.weighted_cov(jm, jnp.asarray(w)), 1e-5)
    np.testing.assert_allclose(np_of(got), np_of(got).T, rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk", [8, 64])
def test_estimate_w_ubm_weight_matches_jax(rng, chunk):
    """From the same W: W_TOL (a batched Cholesky solve per utterance on
    both sides); a chunk that leaves a ragged tail and one that exceeds
    S give the same rows, and a zero-occupancy utterance gives w = 0."""
    jm, tm, js, ts = _case(rng)
    w_mat = np.array(jtv.weighted_cov(jm, jnp.asarray(_ubm_weights(rng))))
    got = ttv.estimate_w_ubm_weight(ts, tm, torch.from_numpy(w_mat),
                                    chunk=chunk)
    want = jtv.estimate_w_ubm_weight(js, jm, jnp.asarray(w_mat), chunk=chunk)
    assert got.shape == (21, 8)
    np.testing.assert_allclose(np_of(got), np_of(want), **W_TOL)
    n0, f0 = ts.n.clone(), ts.f.clone()
    n0[4], f0[4] = 0.0, 0.0
    w0 = ttv.estimate_w_ubm_weight(tstats.BwStats(n0, f0), tm,
                                   torch.from_numpy(w_mat), chunk=chunk)
    assert float(w0[4].abs().max()) == 0.0
    np.testing.assert_allclose(np_of(w0[5:]), np_of(got[5:]), rtol=1e-6,
                               atol=1e-7)


def test_eigen_decomposition_matches_jax(rng):
    """Q's column signs are the eigensolver's, so Q is compared through
    what does not depend on them: QᵀQ = I, Q·diag(λ)·Qᵀ = W (1e-5 of
    scale), D = approximate_tctc (1e-4 of scale, columns in the same
    ascending-eigenvalue order), and the i-vectors
    Q·diag(1/(1+N·D))·Qᵀ·aux (W_TOL scaled to max|w|)."""
    jm, tm, js, ts = _case(rng)
    w_mat = np.array(jtv.weighted_cov(jm, jnp.asarray(_ubm_weights(rng))))
    qt = ttv.eigen_decompose_w(torch.from_numpy(w_mat))
    qj = jtv.eigen_decompose_w(jnp.asarray(w_mat))
    np.testing.assert_allclose(np_of(qt.T @ qt), np.eye(8), atol=1e-5)
    lam = np.linalg.eigvalsh(w_mat.astype(np.float64))
    assert_close_scaled(np_of(qt) * lam[None] @ np_of(qt).T, w_mat, 1e-5)
    np.testing.assert_allclose(np.abs(np_of(qt.T) @ np_of(qj)), np.eye(8),
                               atol=1e-3)
    dt, dj = ttv.approximate_tctc(tm, qt), jtv.approximate_tctc(jm, qj)
    assert dt.shape == (16, 8)
    assert_close_scaled(dt, dj, 1e-4)
    # the same D from a Q with flipped signs
    flip = torch.tensor([1.0, -1.0] * 4)
    np.testing.assert_allclose(np_of(ttv.approximate_tctc(tm, qt * flip)),
                               np_of(dt), rtol=1e-5, atol=1e-6)
    got = ttv.estimate_w_eigen_decomposition(ts, tm, dt, qt)
    want = jtv.estimate_w_eigen_decomposition(js, jm, dj, qj)
    assert_close_scaled(got, want, 2e-5)


def test_approximate_ivectors_near_exact(rng):
    """A sanity bound inside the port, not a parity check: on stats drawn
    from the model's own T (the regime the approximations are made for)
    both approximate i-vectors point the way the exact ones do (mean
    cosine > 0.9)."""
    jg, tg = both_gmms(rng, 16, 6)
    r, s = 8, 40
    t = (rng.standard_normal((r, 16, 6)) * 0.3).astype(np.float32)
    tm = ttv.TvModel.from_ubm(t, tg)
    w_true = rng.standard_normal((s, r)).astype(np.float32)
    n = np.tile(np_of(tg.weights)[None] * 400.0, (s, 1)).astype(np.float32)
    shift = np.einsum("sr,rkd->skd", w_true, t)
    f = n[..., None] * (np_of(tg.means)[None] + shift)
    ts = convert.bw_stats_from_numpy(n, f.astype(np.float32))
    exact = ttv.estimate_w(ts, tm, solver="cholesky")
    w_mat = ttv.weighted_cov(tm, tg.weights)
    q = ttv.eigen_decompose_w(w_mat)
    for approx in (ttv.estimate_w_ubm_weight(ts, tm, w_mat),
                   ttv.estimate_w_eigen_decomposition(
                       ts, tm, ttv.approximate_tctc(tm, q), q)):
        cos = torch.nn.functional.cosine_similarity(approx, exact, dim=1)
        assert float(cos.mean()) > 0.9, float(cos.mean())


def test_orthonormalize_t_matches_jax(rng):
    """QR fixes no signs (unlike fa.jfa.orthonormalize_v), so the two
    packages may differ in the sign of a row: compared through the
    projector onto the rows' space (1e-5) and the rows' Gram matrix
    T·Tᵀ = I; rows agree up to sign."""
    jm, tm, _, _ = _case(rng)
    ot, oj = ttv.orthonormalize_t(tm), jtv.orthonormalize_t(jm)
    assert ot.t.shape == tm.t.shape and ot.t.is_contiguous()
    ft, fj = np_of(ot.t_flat()), np_of(oj.t_flat())
    np.testing.assert_allclose(ft @ ft.T, np.eye(8), atol=1e-5)
    np.testing.assert_allclose(projector(ft), projector(fj), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.abs(ft @ fj.T), np.eye(8), atol=1e-4)
    assert torch.equal(ot.ubm_means, tm.ubm_means)
