"""The whole ported slice against the JAX package, end to end:
init → 3 UBM EM iterations → Baum-Welch stats → exact i-vectors (PCG)
→ cosine scoring → EER, from one numpy corpus and one numpy init.

The init GMM and T are built in numpy (jax.random and torch.Generator
draw different numbers), and bagging is off (probability 1), so no
random draw enters either side.  PCG runs the fixed-count loop
(``pcg_tol=0``) at the same ``chunk`` on both sides.

Tolerances: UBM parameters rtol 1e-4 / atol 1e-5 (f32 roundoff of the
stats through three M-steps); BW stats the JAX suite's CPU budgets (n
1e-4, f 1e-3); i-vectors atol 1e-4·max|w| (the two UBMs already differ
by roundoff, which the extraction carries; the card-side contract of
chip_smoke.py is 1e-3·max|w|); cosine scores atol 1e-4; the EER is
equal.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu.backend.eval import eer as jeer
from lia_ral_tpu.backend.scoring import cosine_scores as jcos
from lia_ral_tpu.fa.stats import bw_stats_batch as jbw
from lia_ral_tpu.fa.tv import TvModel as JTv
from lia_ral_tpu.fa.tv import estimate_w as j_estimate_w
from lia_ral_tpu.gmm import GmmDiag as JGmm
from lia_ral_tpu.gmm import em as jem

from lia_ral_tpu_torch.backend.eval import eer as teer
from lia_ral_tpu_torch.backend.scoring import cosine_scores as tcos
from lia_ral_tpu_torch.convert import gmm_from_numpy
from lia_ral_tpu_torch.fa.stats import bw_stats_batch as tbw
from lia_ral_tpu_torch.fa.tv import TvModel as TTv
from lia_ral_tpu_torch.fa.tv import estimate_w as t_estimate_w
from lia_ral_tpu_torch.gmm import em as tem

from _torch_parity import N_TOL, SUM_TOL, np_of

K, D, R = 8, 6, 6
N_SPK, UTT_PER_SPK, T = 6, 4, 60


def _corpus(rng):
    """Speaker-shifted GMM frames as (S, T, D) with ragged masks."""
    centers = rng.standard_normal((K, D)) * 2.0
    shifts = rng.standard_normal((N_SPK, D)) * 0.8
    s = N_SPK * UTT_PER_SPK
    spk = np.repeat(np.arange(N_SPK), UTT_PER_SPK)
    comp = rng.integers(0, K, (s, T))
    x = (centers[comp] + shifts[spk][:, None, :]
         + rng.standard_normal((s, T, D)) * 0.7).astype(np.float32)
    lens = rng.integers(T // 2, T + 1, s)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return x, mask, spk


def _trials(w, spk):
    """Speaker models from the first two utterances; the other two are
    test segments.  Returns (model vectors, test vectors, target mask)."""
    enrol = np.arange(len(spk)) % UTT_PER_SPK < 2
    models = np.stack([w[(spk == i) & enrol].mean(0) for i in range(N_SPK)])
    tests = w[~enrol]
    target = spk[~enrol][None, :] == np.arange(N_SPK)[:, None]
    return models, tests, target


def test_slice_matches_jax(rng):
    x, mask, spk = _corpus(rng)
    s = x.shape[0]
    xf, wf = x.reshape(-1, D), mask.reshape(-1)
    pick = rng.choice(np.nonzero(wf)[0], K, replace=False)
    init = (np.full(K, 1.0 / K, np.float32), xf[pick].copy(),
            np.broadcast_to(1.0 / xf[wf > 0].var(0), (K, D))
            .astype(np.float32))
    t_mat = (rng.standard_normal((R, K, D)) * 0.1).astype(np.float32)
    cfg = dict(nb_train_it=3, init_variance_flooring=0.05,
               final_variance_flooring=0.05, init_variance_ceiling=10.0,
               final_variance_ceiling=10.0)

    # -- JAX package ----------------------------------------------------------
    ubm_j = jem.train_model(jax.random.key(0), jnp.asarray(xf),
                            jnp.asarray(wf), JGmm.create(*init),
                            jem.TrainCfg(**cfg), chunk=256)
    st_j = jbw(jnp.asarray(x), jnp.asarray(mask), ubm_j)
    w_j = np_of(j_estimate_w(st_j, JTv.from_ubm(t_mat, ubm_j), chunk=16,
                             pcg_tol=0.0))
    m_j, t_j, target = _trials(w_j, spk)
    sc_j = np_of(jcos(jnp.asarray(m_j), jnp.asarray(t_j)))

    # -- port -----------------------------------------------------------------
    ubm_t = tem.train_model(torch.Generator().manual_seed(0),
                            torch.from_numpy(xf), torch.from_numpy(wf),
                            gmm_from_numpy(*init), tem.TrainCfg(**cfg),
                            chunk=256)
    st_t = tbw(torch.from_numpy(x), torch.from_numpy(mask), ubm_t)
    w_t = np_of(t_estimate_w(st_t, TTv.from_ubm(t_mat, ubm_t), chunk=16,
                             pcg_tol=0.0))
    m_t, t_t, _ = _trials(w_t, spk)
    sc_t = np_of(tcos(torch.from_numpy(m_t), torch.from_numpy(t_t)))

    for f in ("weights", "means", "cov_inv"):
        np.testing.assert_allclose(np_of(getattr(ubm_t, f)),
                                   np_of(getattr(ubm_j, f)),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np_of(st_t.n), np_of(st_j.n), **N_TOL)
    np.testing.assert_allclose(np_of(st_t.f), np_of(st_j.f), **SUM_TOL)
    assert w_t.shape == (s, R) and np.isfinite(w_t).all()
    np.testing.assert_allclose(w_t, w_j, rtol=0,
                               atol=1e-4 * np.abs(w_j).max())
    np.testing.assert_allclose(sc_t, sc_j, rtol=0, atol=1e-4)
    eer_t = teer(sc_t[target], sc_t[~target])
    assert eer_t == jeer(sc_j[target], sc_j[~target])
    assert 0.0 <= eer_t < 0.5
