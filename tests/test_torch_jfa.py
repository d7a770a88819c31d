"""PyTorch port vs the JAX package: factor analysis — fa/jfa (the latent
estimators, the V/U/D iterations, training, joint enrolment, the LLK
monitor, dot-product scores), fa/lfa and fa/topgauss.

Sizes: K=8, D=4, Rv=3, Ru=2, 6 speakers × 3 sessions.  The same numpy
arrays go through both packages: models and stats are carried across by
``lia_ral_tpu_torch.convert``, and where a function draws its own init
(``jfa_train``, ``lfa_train``) the draw is patched on both sides to
return one carried model, because ``jax.random`` and a
``torch.Generator`` give different streams.

Tolerances, relative to each array's largest entry: latents and their
covariances 1e-4 (a batched f32 Cholesky solve of L = I + Σ n_c E_c);
one EM iteration 1e-4 (plus a batched solve of A_c); a training of
several iterations 2e-3 (roundoff of the solves compounds).  Nothing
here needs an invariant comparison: ``orthonormalize_v`` fixes the QR
signs, so V is unique.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu.fa import jfa as jjfa
from lia_ral_tpu.fa import lfa as jlfa
from lia_ral_tpu.fa import stats as jstats
from lia_ral_tpu.fa import topgauss as jtop

from lia_ral_tpu_torch import convert
from lia_ral_tpu_torch.fa import jfa as tjfa
from lia_ral_tpu_torch.fa import lfa as tlfa
from lia_ral_tpu_torch.fa import topgauss as ttop

from _torch_parity import assert_close_scaled, both_gmms, np_of

K, D, RV, RU, N_SPK, SESS = 8, 4, 3, 2, 6, 3
LATENT_TOL, ITER_TOL, TRAIN_TOL = 1e-4, 1e-4, 2e-3


def _case(rng, d_scale=0.3):
    """A GMM, a JFA model and session stats drawn from it, in both
    packages: (jgmm, tgmm, jmodel, tmodel, jstats, tstats)."""
    jg, tg = both_gmms(rng, K, D)
    v = (rng.standard_normal((RV, K, D)) * 0.5).astype(np.float32)
    u = (rng.standard_normal((RU, K, D)) * 0.3).astype(np.float32)
    d = (np.abs(rng.standard_normal((K, D))) * d_scale).astype(np.float32)
    means, inv_var = np_of(tg.means), np_of(tg.cov_inv)
    h = N_SPK * SESS
    sess_spk = np.repeat(np.arange(N_SPK), SESS)
    y = rng.standard_normal((N_SPK, RV))
    x = rng.standard_normal((h, RU))
    n = (rng.random((h, K)) * 40 + 2).astype(np.float32)
    offs = (np.einsum("sr,rkd->skd", y, v)[sess_spk]
            + np.einsum("hr,rkd->hkd", x, u))
    f = (n[..., None] * (means[None] + offs)
         + rng.standard_normal((h, K, D)) * 2).astype(np.float32)
    jm = jjfa.JfaModel(v=jnp.asarray(v), u=jnp.asarray(u), d=jnp.asarray(d),
                       ubm_means=jnp.asarray(means),
                       ubm_inv_var=jnp.asarray(inv_var))
    tm = convert.jfa_from_numpy(v, u, d, means, inv_var)
    js = jjfa.JfaStats.from_sessions(
        jstats.BwStats(jnp.asarray(n), jnp.asarray(f)), sess_spk, N_SPK)
    ts = convert.jfa_stats_from_numpy(n, f, sess_spk, N_SPK)
    return jg, tg, jm, tm, js, ts


def _latents(rng):
    """Some y (S,Rv), x (H,Ru), z (S,K,D), as numpy."""
    return ((rng.standard_normal((N_SPK, RV)) * 0.5).astype(np.float32),
            (rng.standard_normal((N_SPK * SESS, RU)) * 0.5)
            .astype(np.float32),
            (rng.standard_normal((N_SPK, K, D)) * 0.2).astype(np.float32))


def _tj(*arrays):
    """Each numpy array as (torch tensor, jax array)."""
    return [(torch.from_numpy(a), jnp.asarray(a)) for a in arrays]


def _assert_jfa_close(got, want, rtol):
    for name in ("v", "u", "d", "ubm_means", "ubm_inv_var"):
        w = np_of(getattr(want, name))
        if np.abs(w).max() > 0:
            assert_close_scaled(getattr(got, name), w, rtol, err_msg=name)
        else:
            assert float(getattr(got, name).abs().max()) == 0.0, name


def test_from_sessions_and_convert(rng):
    """Speaker stats are the sums of their sessions' (1e-6: f32 sums of 3
    rows), the index is kept, and to_numpy nests the two BwStats."""
    _, _, jm, tm, js, ts = _case(rng)
    assert ts.sess_spk.dtype == torch.int64
    np.testing.assert_array_equal(np_of(ts.sess_spk), np_of(js.sess_spk))
    np.testing.assert_allclose(np_of(ts.spk.n), np_of(js.spk.n), rtol=1e-6)
    np.testing.assert_allclose(np_of(ts.spk.f), np_of(js.spk.f), rtol=1e-5,
                               atol=1e-4)
    back = convert.to_numpy(ts)
    assert set(back) == {"spk", "sess", "sess_spk"}
    assert set(back["sess"]) == {"n", "f"}
    np.testing.assert_array_equal(back["sess"]["n"], np_of(js.sess.n))
    assert set(convert.to_numpy(tm)) == {"v", "u", "d", "ubm_means",
                                         "ubm_inv_var"}
    assert (tm.rank_v, tm.rank_u) == (jm.rank_v, jm.rank_u) == (RV, RU)
    assert tm.to("cpu").device.type == "cpu"
    # a tensor index on the stats' device is taken as it is
    again = tjfa.JfaStats.from_sessions(ts.sess, ts.sess_spk, N_SPK)
    assert torch.equal(again.spk.f, ts.spk.f)


def test_supervector_and_speaker_gmm_match_jax(rng):
    jg, tg, jm, tm, _, _ = _case(rng)
    (ty, jy), (tx, jx), (tz, jz) = _tj(*_latents(rng))
    np.testing.assert_allclose(
        np_of(tm.supervector(ty[1], tx[4], tz[1])),
        np_of(jm.supervector(jy[1], jx[4], jz[1])), rtol=1e-5, atol=1e-6)
    sg_t = tm.speaker_gmm(ty[2], tz[2], tg.weights)
    sg_j = jm.speaker_gmm(jy[2], jz[2], jg.weights)
    np.testing.assert_allclose(np_of(sg_t.means), np_of(sg_j.means),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np_of(sg_t.cov_inv), np_of(sg_j.cov_inv))


def test_latent_estimators_match_jax(rng):
    """estimate_y, estimate_x (means and covariances), estimate_z_map:
    LATENT_TOL of scale."""
    _, _, jm, tm, js, ts = _case(rng)
    (ty, jy), (tx, jx), (tz, jz) = _tj(*_latents(rng))
    for got, want in zip(tjfa.estimate_y(ts, tm, tx, tz),
                         jjfa.estimate_y(js, jm, jx, jz)):
        assert_close_scaled(got, want, LATENT_TOL)
    for got, want in zip(tjfa.estimate_x(ts, tm, ty, tz),
                         jjfa.estimate_x(js, jm, jy, jz)):
        assert_close_scaled(got, want, LATENT_TOL)
    # the caller's Gram block changes nothing
    gram = tjfa._subspace_gram(tm.u, tm.ubm_inv_var)
    assert_close_scaled(gram, jjfa._subspace_gram(jm.u, jm.ubm_inv_var),
                        1e-5)
    assert torch.equal(tjfa.estimate_x(ts, tm, ty, tz, gram=gram)[0],
                       tjfa.estimate_x(ts, tm, ty, tz)[0])
    assert_close_scaled(tjfa.estimate_z_map(ts, tm, ty, tx, tau=7.0),
                        jjfa.estimate_z_map(js, jm, jy, jx, tau=7.0),
                        LATENT_TOL)


def test_joint_enrolment_matches_jax(rng):
    """estimate_yx_joint (y, x, covariance over [V;U]), estimate_z_joint
    and enroll_targets_joint: LATENT_TOL of scale."""
    _, _, jm, tm, js, ts = _case(rng)
    (_, _), (_, _), (tz, jz) = _tj(*_latents(rng))
    got = tjfa.estimate_yx_joint(ts, tm, tz)
    want = jjfa.estimate_yx_joint(js, jm, jz)
    assert got[0].shape == (N_SPK, RV) and got[1].shape == (N_SPK, RU)
    assert got[2].shape == (N_SPK, RV + RU, RV + RU)
    for g, w in zip(got, want):
        assert_close_scaled(g, w, LATENT_TOL)
    assert_close_scaled(
        tjfa.estimate_z_joint(ts, tm, got[0], got[1], tau=1.0),
        jjfa.estimate_z_joint(js, jm, want[0], want[1], tau=1.0), LATENT_TOL)
    for g, w in zip(tjfa.enroll_targets_joint(ts, tm, tau=1.0),
                    jjfa.enroll_targets_joint(js, jm, tau=1.0)):
        assert_close_scaled(g, w, LATENT_TOL)


def test_v_u_d_iterations_match_jax(rng):
    """One EM iteration of each subspace from identical state: the new
    V, U, D and the latents they return, ITER_TOL of scale; also the
    shared subspace_em_step and the accumulators it solves."""
    _, _, jm, tm, js, ts = _case(rng)
    (ty, jy), (tx, jx), (tz, jz) = _tj(*_latents(rng))
    tv, y_t = tjfa.jfa_v_iteration(ts, tm, tx, tz)
    jv, y_j = jjfa.jfa_v_iteration(js, jm, jx, jz)
    _assert_jfa_close(tv, jv, ITER_TOL)
    assert_close_scaled(y_t, y_j, LATENT_TOL)
    assert torch.equal(tv.u, tm.u) and tv.v.is_contiguous()
    tu, x_t = tjfa.jfa_u_iteration(ts, tm, ty, tz)
    ju, x_j = jjfa.jfa_u_iteration(js, jm, jy, jz)
    _assert_jfa_close(tu, ju, ITER_TOL)
    assert_close_scaled(x_t, x_j, LATENT_TOL)
    td, z_t = tjfa.jfa_d_iteration(ts, tm, ty, tx, tau=5.0)
    jd, z_j = jjfa.jfa_d_iteration(js, jm, jy, jx, tau=5.0)
    _assert_jfa_close(td, jd, ITER_TOL)
    assert_close_scaled(z_t, z_j, LATENT_TOL)
    # the residuals and the accumulators behind the V substep
    n_t, f_t = tjfa.v_residual(ts, tm, tx, tz)
    n_j, f_j = jjfa.v_residual(js, jm, jx, jz)
    assert_close_scaled(f_t, f_j, 1e-5)
    assert_close_scaled(tjfa.u_residual(ts, tm, ty, tz)[1],
                        jjfa.u_residual(js, jm, jy, jz)[1], 1e-5)
    mean_j, cov_j = jjfa._latent_posterior(
        jm.v, jm.ubm_inv_var, jjfa._subspace_gram(jm.v, jm.ubm_inv_var),
        n_j, f_j)
    acc_j = jjfa._accumulate_subspace(n_j, f_j, mean_j, cov_j)
    acc_t = tjfa._accumulate_subspace(n_t, f_t,
                                      torch.from_numpy(np.array(mean_j)),
                                      torch.from_numpy(np.array(cov_j)))
    assert_close_scaled(acc_t.a, acc_j.a, 1e-5)
    assert_close_scaled(acc_t.c, acc_j.c, 1e-5)
    carried = convert.subspace_accums_from_numpy(np.asarray(acc_j.a),
                                                 np.asarray(acc_j.c))
    assert_close_scaled(tjfa._solve_subspace(carried),
                        jjfa._solve_subspace(acc_j), ITER_TOL)
    merged = carried.merge(carried)
    assert torch.equal(merged.a, 2 * carried.a)
    assert set(convert.to_numpy(carried)) == {"a", "c"}


def test_orthonormalize_v_matches_jax(rng):
    """Signs are fixed to the Gram-Schmidt convention on both sides, so V
    is compared element by element (1e-5), with orthonormal rows."""
    _, _, jm, tm, _, _ = _case(rng)
    ot, oj = tjfa.orthonormalize_v(tm), jjfa.orthonormalize_v(jm)
    assert_close_scaled(ot.v, oj.v, 1e-5)
    flat = np_of(ot.v).reshape(RV, -1)
    np.testing.assert_allclose(flat @ flat.T, np.eye(RV), atol=1e-5)
    # each new row keeps a positive projection on its original row
    assert (np.sum(flat * np_of(tm.v).reshape(RV, -1), axis=1) > 0).all()


def _patch_inits(monkeypatch, jm, tm):
    monkeypatch.setattr(jjfa.JfaModel, "init",
                        classmethod(lambda cls, *a, **k: jm))
    monkeypatch.setattr(tjfa.JfaModel, "init",
                        classmethod(lambda cls, *a, **k: tm))


@pytest.mark.parametrize("its", [(2, 2, 1), (1, 1, 0)],
                         ids=["v2_u2_d1", "v1_u1_d0"])
def test_jfa_train_matches_jax(rng, monkeypatch, its):
    """V, U and D iterations from one carried init (scaled down to the
    size a random init has, D zero as ``JfaModel.init`` leaves it): the
    model and the final y, x, z within TRAIN_TOL of scale."""
    jg, tg, jm, tm, js, ts = _case(rng)
    jm = jm.replace(v=jm.v * 0.1, u=jm.u * 0.1, d=jnp.zeros_like(jm.d))
    tm = tm.replace(v=tm.v * 0.1, u=tm.u * 0.1, d=torch.zeros_like(tm.d))
    _patch_inits(monkeypatch, jm, tm)
    got = tjfa.jfa_train(torch.Generator().manual_seed(0), ts, tg, RV, RU,
                         *its, tau=4.0)
    want = jjfa.jfa_train(jax.random.key(0), js, jg, RV, RU, *its, tau=4.0)
    _assert_jfa_close(got[0], want[0], TRAIN_TOL)
    for g, w, name in zip(got[1:], want[1:], "yxz"):
        if np.abs(np_of(w)).max() > 0:
            assert_close_scaled(g, w, TRAIN_TOL, err_msg=name)
        else:
            assert float(g.abs().max()) == 0.0


def test_jfa_init_is_seeded(rng):
    _, tg = both_gmms(rng, K, D)
    a = tjfa.JfaModel.init(torch.Generator().manual_seed(3), RV, RU, tg,
                           scale=0.01)
    b = tjfa.JfaModel.init(torch.Generator().manual_seed(3), RV, RU, tg,
                           scale=0.01)
    assert a.v.shape == (RV, K, D) and a.u.shape == (RU, K, D)
    assert torch.equal(a.v, b.v) and torch.equal(a.u, b.u)
    assert 0.005 < float(a.v.std()) < 0.02
    assert float(a.d.abs().max()) == 0.0
    assert torch.equal(a.ubm_means, tg.means)


def test_verify_em_llk_and_dot_product_match_jax(rng):
    """The LLK monitor on 2 sessions (rel 1e-5 on a sum of mean frame
    llks) and the dot-product scores (1e-4 of scale)."""
    jg, tg, jm, tm, js, ts = _case(rng)
    (ty, jy), (tx, jx), (tz, jz) = _tj(*_latents(rng))
    frames = rng.standard_normal((3, 25, D)).astype(np.float32)
    mask = (rng.random((3, 25)) > 0.2).astype(np.float32)
    got = tjfa.jfa_verify_em_llk(torch.from_numpy(frames),
                                 torch.from_numpy(mask), ts, tm, tg.weights,
                                 ty, tx, tz, max_sessions=2)
    want = jjfa.jfa_verify_em_llk(jnp.asarray(frames), jnp.asarray(mask), js,
                                  jm, jg.weights, jy, jx, jz, max_sessions=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    n = (rng.random((5, K)) * 30 + 1).astype(np.float32)
    f = (rng.standard_normal((5, K, D)) * 5).astype(np.float32)
    xt = (rng.standard_normal((5, RU)) * 0.5).astype(np.float32)
    for zt, zj in ((None, None), (tz[:4], jz[:4])):
        got = tjfa.jfa_dot_product_scores(
            convert.bw_stats_from_numpy(n, f), tm, ty[:4],
            torch.from_numpy(xt), zt)
        want = jjfa.jfa_dot_product_scores(
            jstats.BwStats(jnp.asarray(n), jnp.asarray(f)), jm, jy[:4],
            jnp.asarray(xt), zj)
        assert got.shape == (4, 5)
        assert_close_scaled(got, want, 1e-4)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_accs_checkpoint_cross_packages(rng, tmp_path, writer):
    """save_accs_npz written by one package and read by the other, bit
    for bit; store_accs / restore_accs hand the same object back."""
    _, _, _, _, js, ts = _case(rng)
    path = os.path.join(str(tmp_path), "accs.npz")
    if writer == "jax":
        jjfa.save_accs_npz(path, js)
        src, got = js, tjfa.load_accs_npz(path)
    else:
        tjfa.save_accs_npz(path, ts)
        src, got = ts, jjfa.load_accs_npz(path)
    for part in ("spk", "sess"):
        for field in ("n", "f"):
            np.testing.assert_array_equal(
                np_of(getattr(getattr(got, part), field)),
                np_of(getattr(getattr(src, part), field)))
    np.testing.assert_array_equal(np_of(got.sess_spk), np_of(src.sess_spk))
    assert tjfa.restore_accs(tjfa.store_accs(ts)) is ts


# -- LFA ------------------------------------------------------------------------

def test_lfa_model_and_train_match_jax(rng, monkeypatch):
    """lfa_model (D = sqrt(Σ/τ): 1e-6) and three U iterations from one
    carried U (both sides' draws patched): TRAIN_TOL of scale."""
    jg, tg, jm, tm, js, ts = _case(rng)
    u0 = np_of(tm.u) * 0.1
    lt, lj = tlfa.lfa_model(torch.from_numpy(u0), tg, tau=9.0), \
        jlfa.lfa_model(jnp.asarray(u0), jg, tau=9.0)
    assert lt.rank_v == 1 and float(lt.v.abs().max()) == 0.0
    np.testing.assert_allclose(np_of(lt.d), np_of(lj.d), rtol=1e-6)
    monkeypatch.setattr(jlfa.jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(u0 * 1000.0))
    monkeypatch.setattr(tlfa.torch, "randn",
                        lambda shape, **kw: torch.from_numpy(u0 * 1000.0))
    got = tlfa.lfa_train(torch.Generator().manual_seed(0), ts, tg, RU,
                         nb_it=3, tau=9.0)
    want = jlfa.lfa_train(jax.random.key(0), js, jg, RU, nb_it=3, tau=9.0)
    _assert_jfa_close(got, want, TRAIN_TOL)


def test_lfa_channel_and_compensation_match_jax(rng):
    """estimate_channel (LATENT_TOL of scale), compensate_features
    (atol 1e-5 on frames of O(1)) and compensate_model (1e-6)."""
    jg, tg, jm, tm, js, ts = _case(rng)
    lt = tlfa.lfa_model(tm.u, tg, tau=16.0)
    lj = jlfa.lfa_model(jm.u, jg, tau=16.0)
    xh_t = tlfa.estimate_channel(ts.sess, lt)
    xh_j = jlfa.estimate_channel(js.sess, lj)
    assert xh_t.shape == (N_SPK * SESS, RU)
    assert_close_scaled(xh_t, xh_j, LATENT_TOL)
    assert torch.equal(
        tlfa.estimate_channel(ts.sess, lt, gram=tlfa.channel_gram(lt)), xh_t)
    frames = rng.standard_normal((40, D)).astype(np.float32)
    got = tlfa.compensate_features(torch.from_numpy(frames), tg, lt, xh_t[2])
    want = jlfa.compensate_features(jnp.asarray(frames), jg, lj, xh_j[2])
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=0, atol=1e-5)
    assert float((got - torch.from_numpy(frames)).abs().max()) > 1e-3
    cm_t = tlfa.compensate_model(tg, lt, xh_t[2])
    cm_j = jlfa.compensate_model(jg, lj, xh_j[2])
    np.testing.assert_allclose(np_of(cm_t.means), np_of(cm_j.means),
                               rtol=1e-5, atol=1e-6)


# -- TopGauss -------------------------------------------------------------------

def _top_case(rng, top=3):
    jg, tg = both_gmms(rng, K, D)
    x = (rng.standard_normal((30, D)) * 1.5).astype(np.float32)
    return (jg, tg, x, jtop.compute_topgauss(jnp.asarray(x), jg, top),
            ttop.compute_topgauss(torch.from_numpy(x), tg, top))


def test_compute_topgauss_matches_jax(rng):
    """The same top sets, their logsumexp and the residual weights to
    1e-5.  The residual log(exp(full) − exp(top)) is ill-conditioned: an
    error ε in (top − full) moves it by ε/(1 − exp(top − full)), so each
    frame's bound is 2e-6 (the f32 error of a logsumexp of O(10)) over
    that factor; the frame llk rebuilt from top + residual is well
    conditioned again (1e-5)."""
    _, _, _, jt, tt = _top_case(rng)
    np.testing.assert_array_equal(tt.indices, jt.indices)
    assert tt.indices.dtype == np.int32 and tt.n_frames == 30
    np.testing.assert_allclose(tt.top_lse, jt.top_lse, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.residual_weight, jt.residual_weight,
                               rtol=1e-5, atol=1e-6)
    full = jt.frame_llk()
    cond = 1.0 / (1.0 - np.exp(np.minimum(jt.top_lse - full, -1e-7)))
    assert (np.abs(tt.residual_log - jt.residual_log)
            <= 1e-5 + 2e-6 * np.abs(full) * cond).all()
    np.testing.assert_allclose(tt.frame_llk(), full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_topgauss_files_cross_packages(rng, tmp_path, writer):
    """Both formats (the .npz cache and the reference wire format) and
    the FileInfo side file, written by one package, read by the other."""
    _, _, _, jt, tt = _top_case(rng)
    src, (wmod, rmod) = ((jt, (jtop, ttop)) if writer == "jax"
                         else (tt, (ttop, jtop)))
    d = str(tmp_path)
    src.save(os.path.join(d, "tg.npz"))
    back = rmod.TopGauss.load(os.path.join(d, "tg.npz"))
    for field in ("indices", "top_lse", "residual_log", "residual_weight"):
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(src, field))
    src.save_reference(os.path.join(d, "tg.bin"))
    ref = rmod.TopGauss.load_reference(os.path.join(d, "tg.bin"))
    np.testing.assert_array_equal(ref.indices, src.indices)
    np.testing.assert_allclose(ref.residual_log, src.residual_log,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ref.residual_weight, src.residual_weight,
                               rtol=1e-7)
    lk = np.exp(src.residual_log.astype(np.float64))
    wmod.write_fileinfo(os.path.join(d, "fi.bin"), src.indices, lk,
                        src.residual_weight)
    idx, lk_back, w_back = rmod.read_fileinfo(os.path.join(d, "fi.bin"), 3)
    np.testing.assert_array_equal(idx, src.indices)
    np.testing.assert_array_equal(lk_back, lk)
    one = rmod.read_fileinfo(os.path.join(d, "fi.bin"), 3, frame=7)
    np.testing.assert_array_equal(one[0], src.indices[7])
    assert one[2] == np.float64(src.residual_weight[7])


def test_topgauss_llk_matches_jax(rng):
    """Another model's llk from the world's cached top set and residual,
    with the SAME cache on both sides (the JAX one), so only the
    evaluation is compared: 1e-5."""
    jg, tg, x, jt, _ = _top_case(rng)
    shift = (rng.standard_normal((K, D)) * 0.2).astype(np.float32)
    got = ttop.topgauss_llk(torch.from_numpy(x),
                            tg.replace(means=tg.means
                                       + torch.from_numpy(shift)),
                            ttop.TopGauss(jt.indices, jt.top_lse,
                                          jt.residual_log,
                                          jt.residual_weight))
    want = jtop.topgauss_llk(jnp.asarray(x),
                             jg.replace(means=jg.means + jnp.asarray(shift)),
                             jt)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-5)
