"""PyTorch port vs the JAX package: fa/tv (TvModel, estimate_tett, the
posteriors, exact i-vector extraction with PCG and Cholesky),
backend/scoring, backend/eval and utils/shapes.

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

from _torch_parity import both_gmms, np_of

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
