"""PyTorch port vs the JAX package: gmm/model, gmm/kernels, gmm/em,
convert, the tier guards and the package's import boundary.

Tolerances: stats use the JAX suite's CPU budgets (_torch_parity: n
rtol/atol 1e-4, sums 1e-3, llk rel 1e-5).  Log-densities of O(10) carry
f32 roundoff of both frameworks' matmuls: rtol 1e-5, atol 1e-4.  Model
parameters after EM iterations: rtol 1e-4, atol 1e-5 (f32 roundoff of
the stats, carried through the closed-form M-step).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lia_ral_tpu.gmm import GmmDiag as JGmm
from lia_ral_tpu.gmm import em as jem
from lia_ral_tpu.gmm import kernels as jk

from lia_ral_tpu_torch import convert
from lia_ral_tpu_torch.gmm import em as tem
from lia_ral_tpu_torch.gmm import kernels as tk
from lia_ral_tpu_torch.gmm.cuda_kernels import (bw_stats_fused,
                                                em_stats_fused,
                                                launch_counts)
from lia_ral_tpu_torch.gmm.model import GmmDiag as TGmm

from _torch_parity import (assert_em_stats_close, both_gmms, np_of,
                           random_gmm_np)

LOGDENS_TOL = dict(rtol=1e-5, atol=1e-4)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
POST_TOL = dict(rtol=1e-4, atol=1e-5)     # posteriors in [0, 1]
REPO = Path(__file__).resolve().parents[1]


def _frames(rng, n, d, zero_frac=0.0):
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < zero_frac] = 0.0
    return x, w


def _assert_gmm_close(tg, jg, tol=PARAM_TOL):
    for f in ("weights", "means", "cov_inv"):
        np.testing.assert_allclose(np_of(getattr(tg, f)),
                                   np_of(getattr(jg, f)), **tol)


# -- model --------------------------------------------------------------------

def test_model_constants_and_constructors(rng):
    jg, tg = both_gmms(rng, 8, 5)
    assert (tg.n_components, tg.dim) == (8, 5)
    np.testing.assert_allclose(np_of(tg.log_const()), np_of(jg.log_const()),
                               rtol=1e-6)
    np.testing.assert_allclose(np_of(tg.log_weights()),
                               np_of(jg.log_weights()), rtol=1e-6)
    np.testing.assert_allclose(np_of(tg.cov), np_of(jg.cov), rtol=1e-6)
    cov = rng.random((8, 5)) + 0.5
    _assert_gmm_close(TGmm.from_cov(np.array(jg.weights), np.array(jg.means),
                                    cov),
                      JGmm.from_cov(jg.weights, jg.means, cov))
    _assert_gmm_close(TGmm.uniform_init(4, 3), JGmm.uniform_init(4, 3))
    half = tg.astype(torch.float64)
    assert half.means.dtype == torch.float64
    assert tg.to("cpu").means.device.type == "cpu"
    with pytest.raises(Exception):
        tg.means = tg.means          # frozen dataclass


# -- kernels (the plain path) -------------------------------------------------

@pytest.mark.parametrize("n,k,d", [(96, 8, 5), (130, 16, 7)])
def test_logdens_and_posteriors_match_jax(rng, n, k, d):
    jg, tg = both_gmms(rng, k, d)
    x, _ = _frames(rng, n, d)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(np_of(tk.component_logdens(xt, tg)),
                               np_of(jk.component_logdens(xj, jg)),
                               **LOGDENS_TOL)
    np.testing.assert_allclose(np_of(tk.weighted_logdens(xt, tg)),
                               np_of(jk.weighted_logdens(xj, jg)),
                               **LOGDENS_TOL)
    np.testing.assert_allclose(np_of(tk.frame_llk(xt, tg, -12.0, -8.0)),
                               np_of(jk.frame_llk(xj, jg, -12.0, -8.0)),
                               **LOGDENS_TOL)
    llk_t, post_t = tk.llk_and_posteriors(xt, tg)
    llk_j, post_j = jk.llk_and_posteriors(xj, jg)
    np.testing.assert_allclose(np_of(llk_t), np_of(llk_j), **LOGDENS_TOL)
    np.testing.assert_allclose(np_of(post_t), np_of(post_j), **POST_TOL)



@pytest.mark.parametrize("n,k,d,chunk", [(96, 8, 5, 32), (130, 16, 7, 64),
                                         (45, 4, 3, 16)])
def test_em_stats_match_jax(rng, n, k, d, chunk):
    jg, tg = both_gmms(rng, k, d)
    x, w = _frames(rng, n, d, zero_frac=0.05)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    want = jk.em_stats(xj, wj, jg)
    assert_em_stats_close(tk.em_stats(xt, wt, tg), want)
    # ragged last chunk (n not a chunk multiple) vs the JAX zero-padded scan
    assert_em_stats_close(tk.em_stats_chunked(xt, wt, tg, chunk=chunk),
                          jk.em_stats_chunked(xj, wj, jg, chunk=chunk))


def test_em_stats_merge_and_mean_llk(rng):
    _, tg = both_gmms(rng, 4, 3)
    x, w = _frames(rng, 40, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    whole = tk.em_stats(xt, wt, tg)
    parts = tk.EmStats.zeros(4, 3).merge(tk.em_stats(xt[:17], wt[:17], tg))
    parts = parts.merge(tk.em_stats(xt[17:], wt[17:], tg))
    assert_em_stats_close(parts, whole)
    np.testing.assert_allclose(float(whole.mean_llk()),
                               float(whole.llk) / float(whole.count),
                               rtol=1e-6)
    assert float(tk.EmStats.zeros(4, 3).mean_llk()) == 0.0


# -- em -----------------------------------------------------------------------

def test_schedule_and_global_mean_cov(rng):
    for args in ((1.0, 0.5, 5, 2), (1.0, 0.5, 1, 0), (10.0, 5.0, 3, 2)):
        assert tem.schedule_value(*args) == pytest.approx(
            jem.schedule_value(*args))
    x, w = _frames(rng, 50, 4)
    mt, ct = tem.global_mean_cov(torch.from_numpy(x), torch.from_numpy(w))
    mj, cj = jem.global_mean_cov(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(np_of(mt), np_of(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_of(ct), np_of(cj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("zero_weights", [False, True])
def test_m_step_variance_control_normalize_match_jax(rng, zero_weights):
    jg, tg = both_gmms(rng, 8, 5)
    x, w = _frames(rng, 120, 5)
    if zero_weights:
        w[:] = 0.0          # empty selection → uniform weights, finite
    st_t = tk.em_stats(torch.from_numpy(x), torch.from_numpy(w), tg)
    st_j = jk.em_stats(jnp.asarray(x), jnp.asarray(w), jg)
    gcov = (rng.random(5) + 0.5).astype(np.float32)
    gm_t = tem._m_step_with_variance_control(st_t, 0.5, 2.0,
                                             torch.from_numpy(gcov))
    gm_j = jem.variance_control(jem.m_step(st_j), 0.5, 2.0,
                                jnp.asarray(gcov))
    _assert_gmm_close(gm_t, gm_j)
    assert all(np.isfinite(np_of(getattr(gm_t, f))).all()
               for f in ("weights", "means", "cov_inv"))
    mean = rng.standard_normal(5).astype(np.float32)
    for mean_only in (False, True):
        _assert_gmm_close(
            tem.normalize_mixture(gm_t, torch.from_numpy(mean),
                                  torch.from_numpy(gcov), mean_only),
            jem.normalize_mixture(gm_j, jnp.asarray(mean), jnp.asarray(gcov),
                                  mean_only))


def test_bagged_frame_mask(rng):
    base = torch.from_numpy((rng.random(5000) > 0.2).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert tem.bagged_frame_mask(gen, base, 1.0) is base
    m1 = tem.bagged_frame_mask(torch.Generator().manual_seed(7), base, 0.3)
    m2 = tem.bagged_frame_mask(torch.Generator().manual_seed(7), base, 0.3)
    assert torch.equal(m1, m2)
    assert set(np.unique(np_of(m1))) <= {0.0, 1.0}
    assert torch.all(m1 <= base)
    frac = float(m1.sum() / base.sum())
    assert 0.2 < frac < 0.4, frac


def test_mixture_init_full_selection_matches_jax(rng):
    """bagged_probability_init ≥ K selects every frame (no random draw),
    so both packages must give the same init."""
    import jax

    x, w = _frames(rng, 200, 4)
    w = (w > 0.3).astype(np.float32)
    gt = tem.mixture_init(torch.Generator().manual_seed(0),
                          torch.from_numpy(x), torch.from_numpy(w), 6,
                          bagged_probability_init=6.0)
    gj = jem.mixture_init(jax.random.key(0), jnp.asarray(x), jnp.asarray(w),
                          6, bagged_probability_init=6.0)
    _assert_gmm_close(gt, gj)


def test_mixture_init_random_selection(rng):
    x, w = _frames(rng, 3000, 4)
    xt, wt = torch.from_numpy(x), torch.ones(3000)
    g1 = tem.mixture_init(torch.Generator().manual_seed(3), xt, wt, 200,
                          bagged_probability_init=20.0)
    g2 = tem.mixture_init(torch.Generator().manual_seed(3), xt, wt, 200,
                          bagged_probability_init=20.0)
    assert torch.equal(g1.means, g2.means)
    assert g1.means.shape == (200, 4)
    np.testing.assert_allclose(np_of(g1.weights), 1 / 200, rtol=1e-6)
    _, gcov = tem.global_mean_cov(xt, wt)
    np.testing.assert_allclose(np_of(g1.cov_inv),
                               np.broadcast_to(1 / np_of(gcov), (200, 4)),
                               rtol=1e-6)
    # each component mean averages its own ~10 % subset, so they differ
    assert len(np.unique(np_of(g1.means)[:, 0])) == 200
    # an empty selection (p ≈ 0) falls back to the global mean
    g0 = tem.mixture_init(torch.Generator().manual_seed(3), xt[:20], wt[:20],
                          4, bagged_probability_init=1e-9)
    np.testing.assert_allclose(np_of(g0.means),
                               np.broadcast_to(x[:20].mean(0), (4, 4)),
                               rtol=1e-5, atol=1e-6)


def test_reduce_model_matches_jax(rng):
    jg, tg = both_gmms(rng, 12, 3)
    _assert_gmm_close(tem.reduce_model(tg, 5), jem.reduce_model(jg, 5))


def test_train_model_matches_jax(rng):
    """3 EM iterations from one numpy init, bagged probability 1 (no
    random mask), plain stats on both sides, plus component reduction."""
    import jax

    k, d, n = 8, 5, 600
    centers = rng.standard_normal((k, d)) * 3.0
    x = (centers[rng.integers(0, k, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    w = np.ones(n, np.float32)
    w[::17] = 0.0
    init = random_gmm_np(rng, k, d)
    cfg_kw = dict(nb_train_it=3, init_variance_flooring=0.1,
                  final_variance_flooring=0.05, init_variance_ceiling=10.0,
                  final_variance_ceiling=5.0, component_reduction=True,
                  target_distrib_count=6)
    gt = tem.train_model(torch.Generator().manual_seed(0),
                         torch.from_numpy(x), torch.from_numpy(w),
                         convert.gmm_from_numpy(*init),
                         tem.TrainCfg(**cfg_kw), chunk=128)
    gj = jem.train_model(jax.random.key(0), jnp.asarray(x), jnp.asarray(w),
                         JGmm.create(*init), jem.TrainCfg(**cfg_kw),
                         chunk=128)
    assert gt.n_components == 6
    _assert_gmm_close(gt, gj)


def test_train_cfg_from_config():
    class Cfg:
        vals = {"nbTrainIt": 7, "initVarianceFlooring": 0.3,
                "baggedFrameProbability": 0.5, "normalizeModel": True,
                "targetMixtureDistribCount": 64}

        def get_int(self, key, default):
            return int(self.vals.get(key, default))

        def get_float(self, key, default):
            return float(self.vals.get(key, default))

        def get_bool(self, key, default):
            return bool(self.vals.get(key, default))

    got = tem.TrainCfg.from_config(Cfg())
    want = jem.TrainCfg.from_config(Cfg())
    assert got.__dict__ == want.__dict__
    assert got.nb_train_it == 7 and got.normalize_model


def test_default_stats_fn_on_cpu_takes_plain_path(rng):
    _, tg = both_gmms(rng, 4, 3)
    x, w = _frames(rng, 70, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = dict(launch_counts)
    got = tem.default_stats_fn(chunk=32)(xt, wt, tg)
    assert launch_counts == before
    assert_em_stats_close(got, tk.em_stats_chunked(xt, wt, tg, chunk=32))


# -- tiers and dispatch ---------------------------------------------------------

def _jax_tier(name, x3, w2, x2, w1, jg):
    """The JAX package's Pallas kernel in interpret mode, in the tier of
    case ``name``, on the same inputs."""
    from lia_ral_tpu.gmm.pallas_kernels import bw_stats_fused as jbw
    from lia_ral_tpu.gmm.pallas_kernels import em_stats_fused as jemf

    kw = (dict(compute_dtype=jnp.bfloat16) if name.endswith(("bf16", "math"))
          else dict(stats_pass="bf16nx"))
    if name.startswith("k2"):
        return jbw(jnp.asarray(x3), jnp.asarray(w2), jg, block=32,
                   interpret=True, **kw)
    return jemf(jnp.asarray(x2), jnp.asarray(w1), jg, block=32,
                interpret=True, **kw)


@pytest.mark.parametrize("call", [
    lambda x3, w2, x2, w1, g: tem.default_stats_fn(fast_math=True)(x2, w1, g),
    lambda x3, w2, x2, w1, g: tem.default_stats_fn(fast_stats=True)(x2, w1,
                                                                    g),
    lambda x3, w2, x2, w1, g: em_stats_fused(x2, w1, g, stats_pass="bf16nx"),
    lambda x3, w2, x2, w1, g: em_stats_fused(x2, w1, g,
                                             compute_dtype=torch.bfloat16),
    lambda x3, w2, x2, w1, g: bw_stats_fused(x3, w2, g, stats_pass="bf16nx"),
    lambda x3, w2, x2, w1, g: bw_stats_fused(x3, w2, g,
                                             compute_dtype=torch.bfloat16),
], ids=["em_fast_math", "em_fast_stats", "k1_bf16nx", "k1_bf16", "k2_bf16nx",
        "k2_bf16"])
def test_unported_tiers_raise(rng, call, request):
    """The six tier entry points that raised NotImplementedError before the
    fastStats and fastMath tiers were ported (the name is kept): each now
    runs its plain version on the CPU, which must match the JAX package's
    Pallas kernel in interpret mode in the same tier, without launching a
    kernel.  Budgets: fastStats n at the default budget (rtol 1e-4, atol
    1e-4·max n), S/F 2e-3·max|·| (the tier's bf16 rounding of p and xa·s,
    measured 1e-3 against the exact path), llk rel 1e-5; fastMath the JAX
    suite's own bf16 budgets (tests/test_pallas_kernel.py:72-80)."""
    name = request.node.callspec.id
    jg, tg = both_gmms(rng, 16, 7)
    x3 = rng.standard_normal((3, 70, 7)).astype(np.float32)
    w2 = (rng.random((3, 70)) > 0.3).astype(np.float32)
    w2[1] = 0.0                             # an all-zero-weight utterance
    x2, w1 = x3.reshape(-1, 7), w2.reshape(-1) * rng.random(210, np.float32)
    before = dict(launch_counts)
    got = call(torch.from_numpy(x3), torch.from_numpy(w2),
               torch.from_numpy(x2), torch.from_numpy(w1), tg)
    assert launch_counts == before
    want = _jax_tier(name, x3, w2, x2, w1, jg)
    if name.startswith("k2"):
        got = (got[0], got[1], got[2])
        pairs = [("n", got[0], want[0]), ("f", got[1], want[1])]
        llk = (got[2], want[2])
        assert torch.all(got[0][1] == 0) and torch.all(got[1][1] == 0)
    else:
        pairs = [("n", got.n, want.n), ("sum_x", got.sum_x, want.sum_x),
                 ("sum_xx", got.sum_xx, want.sum_xx)]
        llk = (got.llk, want.llk)
        np.testing.assert_allclose(float(got.count), float(want.count),
                                   rtol=1e-6)
    fast_math = name.endswith(("bf16", "math"))
    for label, a, b in pairs:
        a, b = np_of(a), np_of(b)
        if fast_math:
            np.testing.assert_allclose(a, b, rtol=0.05,
                                       atol=0.05 if label == "n" else 0.1)
        elif label == "n":
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-4 * np.abs(b).max())
        else:
            np.testing.assert_allclose(a, b, rtol=2e-3,
                                       atol=2e-3 * np.abs(b).max())
    np.testing.assert_allclose(np_of(llk[0]), np_of(llk[1]),
                               rtol=5e-3 if fast_math else 1e-5, atol=1e-3)


def test_sweep_only_modes_rejected(rng):
    _, tg = both_gmms(rng, 4, 3)
    x, w = torch.zeros((8, 3)), torch.ones(8)
    for mode in ("bf16", "bf16sr", "bf16x2p", "bf16x2x"):
        with pytest.raises(ValueError):
            em_stats_fused(x, w, tg, stats_pass=mode)
    with pytest.raises(ValueError):
        em_stats_fused(x, w, tg, compute_dtype=torch.float16)


def test_non_cpu_non_cuda_tensor_has_no_fallback(rng):
    """Only a CPU tensor takes the plain version; any other device must
    reach the kernel's checks and raise, never fall back."""
    _, tg = both_gmms(rng, 4, 3)
    tg_meta = tg.to("meta")
    x = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        em_stats_fused(x, torch.ones(8, device="meta"), tg_meta)
    with pytest.raises(ValueError, match="no kernel"):
        bw_stats_fused(x[None], torch.ones((1, 8), device="meta"), tg_meta)


# -- convert ----------------------------------------------------------------

def test_convert_round_trips(rng):
    from lia_ral_tpu_torch.fa.stats import BwStats
    from lia_ral_tpu_torch.fa.tv import TvModel

    w, m, ci = random_gmm_np(rng, 4, 3)
    g = convert.gmm_from_numpy(w, m, ci)
    back = convert.to_numpy(g)
    assert set(back) == {"weights", "means", "cov_inv"}
    np.testing.assert_array_equal(back["means"], m)
    t = rng.standard_normal((5, 4, 3)).astype(np.float32)
    tv = convert.tv_from_numpy(t, m, ci)
    assert isinstance(tv, TvModel)
    np.testing.assert_array_equal(convert.to_numpy(tv)["t"], t)
    es = convert.em_stats_from_numpy(w, m, ci, 1.5, 2.0)
    assert float(convert.to_numpy(es)["count"]) == 2.0
    bw = convert.bw_stats_from_numpy(m, m[..., None])
    assert isinstance(bw, BwStats)
    np.testing.assert_array_equal(convert.to_numpy(bw)["f"], m[..., None])
    with pytest.raises(TypeError):
        convert.to_numpy(object())


# -- package boundary ---------------------------------------------------------

def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import lia_ral_tpu_torch, lia_ral_tpu_torch._build\n"
        "import lia_ral_tpu_torch.convert, lia_ral_tpu_torch.utils.shapes\n"
        "import lia_ral_tpu_torch.gmm.model, lia_ral_tpu_torch.gmm.kernels\n"
        "import lia_ral_tpu_torch.gmm.cuda_kernels, lia_ral_tpu_torch.gmm.em\n"
        "import lia_ral_tpu_torch.fa.stats, lia_ral_tpu_torch.fa.tv\n"
        "import lia_ral_tpu_torch.backend.scoring\n"
        "import lia_ral_tpu_torch.backend.eval\n"
        "import lia_ral_tpu_torch.config, lia_ral_tpu_torch.io\n"
        "import lia_ral_tpu_torch.io.features, lia_ral_tpu_torch.io.gmm_io\n"
        "import lia_ral_tpu_torch.io.labels, lia_ral_tpu_torch.io.lists\n"
        "import lia_ral_tpu_torch.io.matrix, lia_ral_tpu_torch.io.nist\n"
        "import lia_ral_tpu_torch.__main__, lia_ral_tpu_torch.tools\n"
        "import lia_ral_tpu_torch.tools.common\n"
        "import lia_ral_tpu_torch.tools.train_world\n"
        "import lia_ral_tpu_torch.tools.total_variability\n"
        "import lia_ral_tpu_torch.tools.iv_extractor\n"
        "import lia_ral_tpu_torch.tools.iv_test\n"
        "import lia_ral_tpu_torch.tools.iv_norm\n"
        "import lia_ral_tpu_torch.gmm.map_adapt\n"
        "import lia_ral_tpu_torch.gmm.scoring\n"
        "import lia_ral_tpu_torch.backend.norm\n"
        "import lia_ral_tpu_torch.backend.unsupervised\n"
        "import lia_ral_tpu_torch.frontend\n"
        "import lia_ral_tpu_torch.frontend.energy_vad\n"
        "import lia_ral_tpu_torch.frontend.normfeat\n"
        "import lia_ral_tpu_torch.tools.train_target\n"
        "import lia_ral_tpu_torch.tools.compute_test\n"
        "import lia_ral_tpu_torch.tools.compute_norm\n"
        "import lia_ral_tpu_torch.tools.energy_detector\n"
        "import lia_ral_tpu_torch.tools.norm_feat\n"
        "import lia_ral_tpu_torch.backend.ivnorm\n"
        "import lia_ral_tpu_torch.backend.plda\n"
        "import lia_ral_tpu_torch.fa.jfa, lia_ral_tpu_torch.fa.lfa\n"
        "import lia_ral_tpu_torch.fa.topgauss\n"
        "import lia_ral_tpu_torch.tools.plda_tool\n"
        "import lia_ral_tpu_torch.tools.jfa_tools\n"
        "import lia_ral_tpu_torch.seg, lia_ral_tpu_torch.seg.hmm\n"
        "import lia_ral_tpu_torch.seg.clustering\n"
        "import lia_ral_tpu_torch.seg.diarization\n"
        "import lia_ral_tpu_torch.tools.spkseg_tools\n"
        "import lia_ral_tpu_torch.frontend.mfcc\n"
        "import lia_ral_tpu_torch.frontend.sdc\n"
        "import lia_ral_tpu_torch.tools.spk_adapt\n"
        "import lia_ral_tpu_torch.api, lia_ral_tpu_torch.api.spkdet\n"
        "import lia_ral_tpu_torch.api.server\n"
        "import lia_ral_tpu_torch.api.client\n"
        "import lia_ral_tpu_torch.utils, lia_ral_tpu_torch.utils.logging\n"
        "import lia_ral_tpu_torch.utils.scores, lia_ral_tpu_torch.utils.labels\n"
        "import lia_ral_tpu_torch.utils.ngram, lia_ral_tpu_torch.utils.seqtree\n"
        "import lia_ral_tpu_torch.utils.polyexp\n"
        "import lia_ral_tpu_torch.utils.tokenizer\n"
        "import lia_ral_tpu_torch.io.repair\n"
        "import lia_ral_tpu_torch.backend.supervector\n"
        "import lia_ral_tpu_torch.backend.svm\n"
        "import lia_ral_tpu_torch.tools.utils_tools\n"
        "import lia_ral_tpu_torch.parallel, lia_ral_tpu_torch.parallel.mesh\n"
        "import lia_ral_tpu_torch.parallel.sharding\n"
        "import lia_ral_tpu_torch.parallel.distributed\n"
        "import lia_ral_tpu_torch.io.native\n"
        "sys.path.insert(0, 'scripts')\n"
        "import torch_oracle_parity\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'lia_ral_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# JAX modules the port has no file for, and why: the Pallas kernels are
# replaced by the CUDA ones; stagemon's jax.monitoring compile counters
# are on ROADMAP.md's "Do not port" list
NO_COUNTERPART = {"gmm/pallas_kernels.py": "gmm/cuda_kernels.py",
                  "utils/stagemon.py": None}


def test_every_jax_module_has_a_port_counterpart():
    """Walks the file names of lia_ral_tpu/ (without importing it): each
    module has a file of the same path in lia_ral_tpu_torch/, but for the
    two of NO_COUNTERPART."""
    jax_root = Path(REPO) / "lia_ral_tpu"
    port_root = Path(REPO) / "lia_ral_tpu_torch"
    missing = []
    for f in sorted(jax_root.rglob("*.py")):
        rel = f.relative_to(jax_root).as_posix()
        if "__pycache__" in rel:
            continue
        if rel in NO_COUNTERPART:
            other = NO_COUNTERPART[rel]
            assert other is None or (port_root / other).is_file(), other
            continue
        if not (port_root / rel).is_file():
            missing.append(rel)
    assert not missing, missing
    assert (port_root / "parallel" / "sharding.py").is_file()


def test_chip_smoke_fails_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    card, and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    runs = [(REPO, REPO / "chip_smoke.py")]
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    runs.append((tmp_path, alone))
    for cwd, script in runs:
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("lens,bucket,batch", [
    ([2000] * 250, 2048, 64), ([700, 2048, 1500, 3000, 900, 2049, 100], 2048,
                               4), ([5, 9, 17, 33], 8, 1), ([12], 2048, 64)])
def test_chip_smoke_launch_rule_is_the_bucketing_rule(monkeypatch, lens,
                                                      bucket, batch):
    """The K2 launch count chip_smoke.py expects of a stats tool
    (``k2_batches``) is the number of ``bw_stats_batch`` calls that
    ``bw_stats_bucketed`` makes for files of those lengths."""
    import importlib.util

    from lia_ral_tpu_torch.fa import stats as tstats

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    calls = []

    def counted(x, mask, gmm, **kwargs):
        calls.append(tuple(x.shape))
        s, k = x.shape[0], gmm.n_components
        return tstats.BwStats(n=torch.zeros((s, k)),
                              f=torch.zeros((s, k, x.shape[2])))

    monkeypatch.setattr(tstats, "bw_stats_batch", counted)
    _, tg = both_gmms(np.random.default_rng(0), 4, 3)
    entries = [(np.zeros((n, 3), np.float32), np.ones(n, np.float32))
               for n in lens]
    out = tstats.bw_stats_bucketed(entries, tg, bucket=bucket,
                                   batch_size=batch)
    assert out.n.shape == (len(lens), 4)
    assert len(calls) == smoke.k2_batches(lens, bucket, batch)
    assert all(t % bucket == 0 for _, t, _ in calls)
