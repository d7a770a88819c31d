"""PyTorch port vs the JAX package: the i-vector back end — backend/ivnorm
(covariances, EFR and sphNorm, LDA, WCCN, Mahalanobis), backend/scoring
(Mahalanobis and two-covariance scores) and backend/plda (one EM
iteration, training, scoring, both file formats).

The same numpy arrays go through both packages (state is carried across
by ``lia_ral_tpu_torch.convert``).  Dev sets hold N ≥ 4·R vectors, so
that the covariances both sides invert are well conditioned and two LU /
Cholesky routines agree near f32 roundoff; the one exception is the
rank-deficient EFR case, which is the point of that test.

What ``eigh`` returns is compared through invariants (helpers in
_torch_parity.py): LAPACK and XLA:CPU differ in the signs of
eigenvectors, so a whitening matrix M is compared as MᵀM (= Σ⁻¹), the
normalised vectors as their Gram matrix (they agree up to one orthogonal
map), an LDA projection as the projector onto its row space.  Matrices
that are unique (covariances, the WCCN Cholesky factor with its positive
diagonal, W⁻¹, PLDA's F after its Cholesky whitening) are compared
element by element.  Tolerances are relative to each array's largest
entry (``assert_close_scaled``) and stated per test.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu.backend import ivnorm as jiv
from lia_ral_tpu.backend import plda as jplda
from lia_ral_tpu.backend import scoring as jscoring

from lia_ral_tpu_torch import convert
from lia_ral_tpu_torch.backend import ivnorm as tiv
from lia_ral_tpu_torch.backend import plda as tplda
from lia_ral_tpu_torch.backend import scoring as tscoring

from _torch_parity import (assert_close_scaled, gram, metric, np_of,
                           projector)

R, N_SPK, SESS = 12, 20, 5          # N = 100 ≥ 4·R


def _vectors(rng, r=R, n_spk=N_SPK, sess=SESS, rank=4):
    """Speaker-structured vectors x = μ + F·h_s + ε and their labels."""
    f = rng.standard_normal((r, rank))
    h = rng.standard_normal((n_spk, rank))
    x = (0.3 + np.repeat(h @ f.T, sess, axis=0)
         + 0.7 * rng.standard_normal((n_spk * sess, r)))
    labels = [f"spk{s}" for s in range(n_spk) for _ in range(sess)]
    return x.astype(np.float32), labels


def _both_devs(rng, **kw):
    x, labels = _vectors(rng, **kw)
    return jiv.DevSet.from_labels(x, labels), tiv.DevSet.from_labels(x,
                                                                     labels)


def test_dev_set_length_norm_and_convert(rng):
    x, labels = _vectors(rng)
    order = rng.permutation(len(labels))
    x, labels = x[order], [labels[i] for i in order]
    jd, td = jiv.DevSet.from_labels(x, labels), tiv.DevSet.from_labels(x,
                                                                       labels)
    assert td.n_speakers == jd.n_speakers == N_SPK
    np.testing.assert_array_equal(np_of(td.spk_ids), np_of(jd.spk_ids))
    assert td.spk_ids.dtype == torch.int64
    carried = convert.dev_set_from_numpy(np.asarray(jd.vectors),
                                         np.asarray(jd.spk_ids),
                                         jd.n_speakers)
    assert torch.equal(carried.vectors, td.vectors)
    assert torch.equal(carried.spk_ids, td.spk_ids)
    x[3] = 0.0                              # a zero vector stays finite
    np.testing.assert_allclose(np_of(tiv.length_norm(torch.from_numpy(x))),
                               np_of(jiv.length_norm(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    assert td.to("cpu").vectors.device.type == "cpu"


def test_cov_matrices_match_jax(rng):
    """Σ, W, B: sums of 100 outer products in f32, rtol 1e-5 of scale;
    and Σ = W + B on both sides."""
    jd, td = _both_devs(rng)
    got, want = tiv.compute_cov_matrices(td), jiv.compute_cov_matrices(jd)
    for g, w in zip(got, want):
        assert_close_scaled(g, w, 1e-5)
    assert_close_scaled(got[1] + got[2], got[0], 1e-5)


@pytest.mark.parametrize("mode", ["EFR", "sphNorm"])
@pytest.mark.parametrize("n_it", [1, 2])
def test_efr_iterations_match_jax(rng, mode, n_it):
    """The normalised dev vectors agree up to one orthogonal map (Gram
    matrix, 1e-4: unit vectors, so entries are cosines), the first
    iteration's mean element-wise, its whitening matrix as MᵀM = Σ⁻¹
    (1e-4 of scale), and held-out vectors sent through each side's own
    transforms agree in their Gram matrix too."""
    jd, td = _both_devs(rng)
    xt, pt = tiv.efr_iterations(td, n_it, mode)
    xj, pj = jiv.efr_iterations(jd, n_it, mode)
    assert len(pt) == len(pj) == n_it
    np.testing.assert_allclose(np.linalg.norm(np_of(xt), axis=1), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(gram(xt), gram(xj), rtol=0, atol=1e-4)
    assert_close_scaled(pt[0][0], pj[0][0], 1e-5)
    assert_close_scaled(metric(pt[0][1]), metric(pj[0][1]), 1e-4)
    held = rng.standard_normal((7, R)).astype(np.float32)
    ht = tiv.apply_efr(torch.from_numpy(held), pt)
    hj = jiv.apply_efr(jnp.asarray(held), pj)
    np.testing.assert_allclose(gram(ht), gram(hj), rtol=0, atol=1e-4)
    # the dev vectors are what apply_efr gives on the dev set
    np.testing.assert_allclose(np_of(tiv.apply_efr(td.vectors, pt)),
                               np_of(xt), rtol=0, atol=1e-6)


def test_efr_rank_deficient_floor_matches_jax(rng):
    """Fewer dev vectors (10) than dimensions (12): the null directions
    are floored at trace/R in both packages.  MᵀM is a matrix function
    of Σ, so it is the same whatever basis each eigensolver picks inside
    the floored (repeated-eigenvalue) space: 1e-4 of scale; without the
    floor it would be ~1e12 there."""
    jd, td = _both_devs(rng, n_spk=5, sess=2)
    assert td.vectors.shape[0] - 1 < R
    xt, pt = tiv.efr_iterations(td, 1)
    xj, pj = jiv.efr_iterations(jd, 1)
    mt = metric(pt[0][1])
    assert_close_scaled(mt, metric(pj[0][1]), 1e-4)
    sigma = np_of(tiv.compute_cov_matrices(td)[0]).astype(np.float64)
    # every eigenvalue of Σ is clipped to ≥ trace/R, so MᵀM ≤ R/trace
    assert np.linalg.eigvalsh(mt).max() < 1.01 * R / np.trace(sigma)
    np.testing.assert_allclose(gram(xt), gram(xj), rtol=0, atol=1e-4)


def test_apply_efr_carried_params_matches_jax(rng):
    """The same (mean, M) pairs in both packages: element-wise, 1e-5."""
    params = [(rng.standard_normal(R).astype(np.float32),
               rng.standard_normal((R, R)).astype(np.float32))
              for _ in range(2)]
    x = rng.standard_normal((9, R)).astype(np.float32)
    got = tiv.apply_efr(torch.from_numpy(x),
                        [(torch.from_numpy(m), torch.from_numpy(a))
                         for m, a in params])
    want = jiv.apply_efr(jnp.asarray(x),
                         [(jnp.asarray(m), jnp.asarray(a))
                          for m, a in params])
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rank", [3, 8])
def test_lda_matches_jax(rng, rank):
    """The projection rows span the same space (projector, 1e-3: the
    eigenvectors of W^-½·B·W^-½ with separated eigenvalues), and each
    side's rows are W-orthonormal (P·W·Pᵀ = I within 1e-3)."""
    jd, td = _both_devs(rng)
    pt, pj = tiv.compute_lda(td, rank), jiv.compute_lda(jd, rank)
    assert pt.shape == (rank, R)
    np.testing.assert_allclose(projector(pt), projector(pj), rtol=0,
                               atol=1e-3)
    w = np_of(tiv.compute_cov_matrices(td)[1]).astype(np.float64) \
        + 1e-6 * np.eye(R)
    p = np_of(pt).astype(np.float64)
    np.testing.assert_allclose(p @ w @ p.T, np.eye(rank), atol=1e-3)


def test_wccn_and_mahalanobis_match_jax(rng):
    """Both unique (a Cholesky factor has a positive diagonal): 1e-4 of
    scale, the f32 inverse of a covariance of condition ~10."""
    jd, td = _both_devs(rng)
    lt, lj = tiv.compute_wccn(td), jiv.compute_wccn(jd)
    assert_close_scaled(lt, lj, 1e-4)
    mt, mj = tiv.compute_mahalanobis(td), jiv.compute_mahalanobis(jd)
    assert_close_scaled(mt, mj, 1e-4)
    # Lᵀ as returned: x @ L whitens, so L·Lᵀ = W⁻¹
    assert_close_scaled(np_of(lt).T @ np_of(lt), np_of(mt), 1e-4)


def _spd(rng, r, scale=1.0):
    a = rng.standard_normal((r, 3 * r))
    return (scale * (a @ a.T) / (3 * r)).astype(np.float32)


def test_scorings_match_jax(rng):
    """mahalanobis_scores, two_cov_model and two_cov_scores from the same
    metric / W / B (random SPD, condition ~10): 1e-4 of scale (three f32
    inverses in G' and H')."""
    m = rng.standard_normal((6, R)).astype(np.float32)
    s = rng.standard_normal((9, R)).astype(np.float32)
    w, b = _spd(rng, R), _spd(rng, R, 2.0)
    tm, ts, tw, tb = (torch.from_numpy(a) for a in (m, s, w, b))
    jm, js, jw, jb = (jnp.asarray(a) for a in (m, s, w, b))
    assert_close_scaled(tscoring.mahalanobis_scores(tm, ts, tw),
                        jscoring.mahalanobis_scores(jm, js, jw), 1e-5)
    for g, want in zip(tscoring.two_cov_model(tw, tb),
                       jscoring.two_cov_model(jw, jb)):
        assert_close_scaled(g, want, 1e-4)
    got = tscoring.two_cov_scores(tm, ts, tw, tb)
    assert got.shape == (6, 9)
    assert_close_scaled(got, jscoring.two_cov_scores(jm, js, jw, jb), 1e-4)
    # a model scored against itself beats the other segments (Mahalanobis)
    self_sc = tscoring.mahalanobis_scores(tm, tm, tw)
    assert torch.equal(self_sc.argmax(1), torch.arange(6))


# -- PLDA -----------------------------------------------------------------------

def _plda_case(rng, rank_f, rank_g):
    """A dev set and an initial model (Σ = data covariance, as
    ``plda_train`` starts), identical in both packages."""
    x, labels = _vectors(rng)
    jd, td = jiv.DevSet.from_labels(x, labels), tiv.DevSet.from_labels(x,
                                                                       labels)
    mean = x.mean(0)
    cov = np.cov(x.T, bias=True).astype(np.float32)
    arrays = dict(mean=mean,
                  f=(rng.standard_normal((R, rank_f)) * 0.1)
                  .astype(np.float32),
                  g=(rng.standard_normal((R, rank_g)) * 0.1)
                  .astype(np.float32), sigma=cov)
    jm = jplda.PldaModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jd, td, jm, convert.plda_from_numpy(**arrays)


def _assert_plda_close(got, want, rtol):
    for name in ("mean", "f", "g", "sigma"):
        g, w = np_of(getattr(got, name)), np_of(getattr(want, name))
        assert g.shape == w.shape, name
        if w.size:
            assert_close_scaled(g, w, rtol, err_msg=name)


@pytest.mark.parametrize("rank_g", [0, 3])
def test_plda_em_core_matches_jax(rng, rank_g):
    """One EM iteration from identical state: every matrix within 1e-4
    of its scale (f32 inverses of Σ, of the per-speaker L and of E[yyᵀ];
    F and G are unique after their Cholesky whitening).  A second
    iteration from each side's own state stays within 1e-3."""
    jd, td, jm, tm = _plda_case(rng, 4, rank_g)
    t1 = tplda.plda_em_iteration(tm, td)
    j1 = jplda.plda_em_iteration(jm, jd)
    assert t1.rank_f == 4 and t1.rank_g == rank_g
    _assert_plda_close(t1, j1, 1e-4)
    _assert_plda_close(tplda.plda_em_iteration(t1, td),
                       jplda.plda_em_iteration(j1, jd), 1e-3)
    back = convert.to_numpy(t1)
    assert set(back) == {"mean", "f", "g", "sigma"}


@pytest.mark.parametrize("rank_g", [0, 2])
def test_plda_em_core_padding_weights_and_reduce_fn(rng, rank_g):
    """Padding rows (w = 0, arbitrary vectors) leave the result as it is
    without them (1e-5 of scale: the same sums with zeros added), in the
    port and against JAX with the same padding; ``reduce_fn`` is applied
    to every cross-session sum (identity here)."""
    jd, td, jm, tm = _plda_case(rng, 3, rank_g)
    pad = rng.standard_normal((6, R)).astype(np.float32) * 5
    x = np.concatenate([np_of(td.vectors), pad])
    ids = np.concatenate([np_of(td.spk_ids), np.zeros(6, np.int64)])
    w = np.concatenate([np.ones(len(td.vectors)), np.zeros(6)]).astype(
        np.float32)
    calls = []

    def reduce_fn(v):
        calls.append(v.shape)
        return v

    got = tplda.plda_em_core(tm, torch.from_numpy(x), torch.from_numpy(ids),
                             td.n_speakers, w=torch.from_numpy(w),
                             reduce_fn=reduce_fn)
    assert len(calls) >= 7
    _assert_plda_close(got, tplda.plda_em_iteration(tm, td), 1e-5)
    want = jplda.plda_em_core(jm, jnp.asarray(x),
                              jnp.asarray(ids.astype(np.int32)),
                              jd.n_speakers, w=jnp.asarray(w))
    _assert_plda_close(got, want, 1e-4)


def _trial_vectors(rng, sessions):
    """Enrolment means over ``sessions[m]`` vectors per model, and test
    vectors."""
    enroll = np.stack([rng.standard_normal((n, R)).mean(0)
                       for n in sessions]).astype(np.float32)
    return enroll, rng.standard_normal((11, R)).astype(np.float32)


@pytest.mark.parametrize("sessions", [[1] * 5, [3, 1, 5, 2, 2]],
                         ids=["one_session", "several_sessions"])
def test_plda_llr_matches_jax(rng, sessions):
    """Scores from one carried model (after an EM iteration, so Σ, F, G
    are realistic): 1e-4 of the scores' scale (a batched Cholesky of
    F·C_m·Fᵀ + W̃ per model)."""
    jd, td, jm, tm = _plda_case(rng, 4, 2)
    j1 = jplda.plda_em_iteration(jm, jd)
    t1 = convert.plda_from_numpy(**{k: np.asarray(getattr(j1, k))
                                    for k in ("mean", "f", "g", "sigma")})
    enroll, test = _trial_vectors(rng, sessions)
    ns = np.asarray(sessions, np.float32)
    got = tplda.plda_llr(t1, torch.from_numpy(enroll), torch.from_numpy(ns),
                         torch.from_numpy(test))
    want = jplda.plda_llr(j1, jnp.asarray(enroll), jnp.asarray(ns),
                          jnp.asarray(test))
    assert got.shape == (5, 11)
    assert_close_scaled(got, want, 1e-4)
    # the score of a model does not depend on its batch peers
    one = tplda.plda_llr(t1, torch.from_numpy(enroll[2:3]),
                         torch.from_numpy(ns[2:3]), torch.from_numpy(test))
    np.testing.assert_allclose(np_of(one[0]), np_of(got[2]), rtol=1e-5,
                               atol=1e-5)


def test_plda_train_from_carried_init_matches_jax(rng):
    """Five EM iterations from the same initial matrices (the random
    streams differ, so the init is carried): compared loosely, as f32
    roundoff of the inverses compounds: F·Fᵀ and Σ within 1e-2 of scale,
    and the trial scores of the two trained models within 1e-2 of the
    scores' scale with correlation > 0.9999."""
    jd, td, jm, tm = _plda_case(rng, 4, 2)
    jt = jplda.plda_train(jax.random.key(0), jd, 4, 2, n_iterations=5,
                          init=jm)
    tt = tplda.plda_train(None, td, 4, 2, n_iterations=5, init=tm)
    ft, fj = np_of(tt.f), np_of(jt.f)
    assert_close_scaled(ft @ ft.T, fj @ fj.T, 1e-2)
    assert_close_scaled(tt.sigma, jt.sigma, 1e-2)
    enroll, test = _trial_vectors(rng, [2] * 6)
    ns = np.full(6, 2.0, np.float32)
    got = np_of(tplda.plda_llr(tt, torch.from_numpy(enroll),
                               torch.from_numpy(ns), torch.from_numpy(test)))
    want = np_of(jplda.plda_llr(jt, jnp.asarray(enroll), jnp.asarray(ns),
                                jnp.asarray(test)))
    assert_close_scaled(got, want, 1e-2)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def test_plda_train_random_init_is_seeded(rng):
    """Without ``init`` the draw comes from the generator: the same seed
    gives the same model, another seed another; Σ starts as the data
    covariance and training keeps every matrix finite."""
    _, td, _, _ = _plda_case(rng, 3, 0)
    runs = [tplda.plda_train(torch.Generator().manual_seed(s), td, 3, 1,
                             n_iterations=2) for s in (5, 5, 6)]
    assert torch.equal(runs[0].f, runs[1].f)
    assert not torch.equal(runs[0].f, runs[2].f)
    for t in (runs[0].mean, runs[0].f, runs[0].g, runs[0].sigma):
        assert bool(torch.isfinite(t).all())
    m = tplda.PldaModel.init(torch.Generator().manual_seed(1), R, 4, 2)
    assert m.f.shape == (R, 4) and m.g.shape == (R, 2)
    assert 0.05 < float(m.f.std()) < 0.2
    assert torch.equal(m.sigma, torch.eye(R)) and float(m.mean.abs().max()) == 0
    assert torch.equal(m.within_cov(), m.g @ m.g.T + m.sigma)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_plda_files_cross_packages(rng, tmp_path, writer):
    """The .npz and the reference's five .matx files written by one
    package and read by the other: f32 values survive both exactly (the
    .matx files hold f64)."""
    _, _, jm, tm = _plda_case(rng, 4, 2)
    d = str(tmp_path)
    paths = [os.path.join(d, n + ".matx")
             for n in ("mean", "F", "G", "Sigma", "minDiv")]
    if writer == "jax":
        jm.save(os.path.join(d, "m.npz"))
        jm.save_reference(*paths)
        got = [tplda.PldaModel.load(os.path.join(d, "m.npz")),
               tplda.PldaModel.load_reference(*paths[:4])]
    else:
        tm.save(os.path.join(d, "m.npz"))
        tm.save_reference(*paths)
        got = [jplda.PldaModel.load(os.path.join(d, "m.npz")),
               jplda.PldaModel.load_reference(*paths[:4])]
    for model in got:
        for name in ("mean", "f", "g", "sigma"):
            np.testing.assert_array_equal(np_of(getattr(model, name)),
                                          np_of(getattr(tm, name)))
    # no eigenchannel file: G is (R, 0)
    no_g = tplda.PldaModel.load_reference(paths[0], paths[1], None, paths[3])
    assert no_g.g.shape == (R, 0) and no_g.rank_g == 0
    from lia_ral_tpu_torch.io.matrix import read_matrix_file
    assert read_matrix_file(paths[0]).shape == (R, 1)
    np.testing.assert_array_equal(read_matrix_file(paths[4]),
                                  read_matrix_file(paths[0]))


def test_cholesky_of_non_pd_gives_nan_as_jax():
    """A covariance that is not positive definite: NaN factors and NaN
    scores in both packages, no exception (a tool goes on and its score
    file shows the NaNs)."""
    bad = np.diag([1.0, -1.0, 2.0]).astype(np.float32)
    assert bool(torch.isnan(tplda._cholesky(torch.from_numpy(bad))).any())
    assert bool(jnp.isnan(jnp.linalg.cholesky(jnp.asarray(bad))).any())
    good = tplda._cholesky(torch.eye(3) * 4.0)
    assert torch.equal(good, torch.eye(3) * 2.0)
    arrays = dict(mean=np.zeros(3, np.float32),
                  f=np.eye(3, 2, dtype=np.float32),
                  g=np.zeros((3, 0), np.float32), sigma=bad)
    x = np.ones((2, 3), np.float32)
    ns = np.ones(2, np.float32)
    got = tplda.plda_llr(convert.plda_from_numpy(**arrays),
                         torch.from_numpy(x), torch.from_numpy(ns),
                         torch.from_numpy(x))
    want = jplda.plda_llr(
        jplda.PldaModel(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(x), jnp.asarray(ns), jnp.asarray(x))
    assert bool(torch.isnan(got).all()) and bool(jnp.isnan(want).all())
