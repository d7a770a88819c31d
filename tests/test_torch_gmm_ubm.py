"""PyTorch port vs the JAX package, GMM-UBM library: gmm/map_adapt,
gmm/scoring, backend/norm, frontend/normfeat, frontend/energy_vad, and
the convert helper that stacks client GMMs.

Both packages get the same numpy inputs from a seed (K ≤ 64, D ≤ 10).
Tolerances, stated per test:
- MAP/MLLR updates are elementwise f32 formulas: rtol 1e-5, atol 1e-6;
  MLLR's batched solve and ``adapt_model``'s EM iterations carry the f32
  roundoff of the stats: rtol 1e-4, atol 1e-5 (the port's EM budget,
  tests/test_torch_gmm.py).
- Top-K per-frame llks of O(10-100) carry the f32 roundoff of both
  frameworks' density matmuls: rtol 1e-5, atol 1e-4.  The port's
  ``torch.topk`` and ``jax.lax.top_k`` could break true ties in world
  densities differently; the random inputs here have none, and the
  selected index sets are asserted equal.  LLRs (means of those llks):
  atol 1e-5.
- Norms: rtol 1e-5, atol 1e-5 on normalised scores of O(1).
- Normalised features: atol 1e-5 (CMVN prefix sums over ≤ 600 frames
  round differently in cumsum order than XLA's); warping atol 1e-5
  (the ranks are exact integers, ndtri differs by ulps).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu.gmm.model import GmmDiag as JGmm

from lia_ral_tpu_torch import convert
from lia_ral_tpu_torch.backend import norm as tnorm
from lia_ral_tpu_torch.frontend import energy_vad as tvad
from lia_ral_tpu_torch.frontend import normfeat as tnf
from lia_ral_tpu_torch.gmm import map_adapt as tmap
from lia_ral_tpu_torch.gmm import scoring as tsc
from lia_ral_tpu_torch.gmm.cuda_kernels import launch_counts

from _torch_parity import both_gmms, np_of, random_gmm_np

# by module path: lia_ral_tpu.gmm re-exports a function named map_adapt
jnorm, jvad, jnf, jmap, jsc = (importlib.import_module(f"lia_ral_tpu.{m}")
                               for m in ("backend.norm", "frontend.energy_vad",
                                         "frontend.normfeat",
                                         "gmm.map_adapt", "gmm.scoring"))

UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)
EM_TOL = dict(rtol=1e-4, atol=1e-5)
LLK_TOL = dict(rtol=1e-5, atol=1e-4)
LLR_TOL = dict(rtol=0, atol=1e-5)
NORM_TOL = dict(rtol=1e-5, atol=1e-5)
FEAT_TOL = dict(rtol=0, atol=1e-5)


def _gmm_close(tg, jg, tol):
    for f in ("weights", "means", "cov_inv"):
        np.testing.assert_allclose(np_of(getattr(tg, f)),
                                   np_of(getattr(jg, f)), **tol)


def _gmm_data(rng, n, k, d):
    """Frames drawn from a K-component GMM with well separated means."""
    centers = rng.standard_normal((k, d)) * 2.0
    x = centers[rng.integers(0, k, n)] + rng.standard_normal((n, d)) * 0.7
    return x.astype(np.float32)


# -- gmm/map_adapt --------------------------------------------------------------

MAP_CASES = {
    "MAPConst": dict(method="MAPConst", mean_r=0.75),
    "MAPConst_no_mean": dict(method="MAPConst", mean_r=0.75,
                             mean_adapt=False),
    "MAPConst2": dict(method="MAPConst2", mean_r=0.6),
    "MAPOccDep_mean": dict(method="MAPOccDep"),
    "MAPOccDep_all": dict(method="MAPOccDep", var_adapt=True,
                          weight_adapt=True, var_r=10.0, weight_r=7.0),
    "MAPModelBased": dict(method="MAPModelBased", var_adapt=True),
}


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_map_adapt_matches_jax(case):
    rng = np.random.default_rng(1)
    jw, tw = both_gmms(rng, 32, 6)
    je, te = both_gmms(rng, 32, 6)
    kw = MAP_CASES[case]
    got = tmap.map_adapt(tw, te, torch.tensor(517.0), tmap.MapCfg(**kw))
    want = jmap.map_adapt(jw, je, jnp.float32(517.0), jmap.MapCfg(**kw))
    _gmm_close(got, want, UPDATE_TOL)


def test_map_cfg_from_config_matches_jax():
    from lia_ral_tpu.config import Config as JConfig
    from lia_ral_tpu_torch.config import Config as TConfig

    for keys in ({}, {"MAPAlgo": "MAPConst", "MAPAlphaMean": 0.3,
                      "meanAdapt": "true"},
                 {"MAPAlgo": "MAPOccDep", "MAPRegFactorMean": 9,
                  "varAdapt": "true", "weightAdapt": "true",
                  "MAPRegFactorVar": 3, "nbTrainIt": 4,
                  "baggedFrameProbability": 0.5}):
        assert (tmap.MapCfg.from_config(TConfig(keys)).__dict__
                == jmap.MapCfg.from_config(JConfig(keys)).__dict__)


def test_compute_mllr_matches_jax():
    rng = np.random.default_rng(2)
    jw, tw = both_gmms(rng, 24, 5)
    w, m, ci = random_gmm_np(rng, 24, 5)
    # the EM estimate: world means moved by an affine map plus noise
    m = (np_of(jw.means) @ (np.eye(5) * 1.1) + 0.3
         + 0.05 * m).astype(np.float32)
    je, te = JGmm.create(w, m, ci), convert.gmm_from_numpy(w, m, ci)
    got, got_w = tmap.compute_mllr(tw, te, torch.tensor(900.0))
    want, want_w = jmap.compute_mllr(jw, je, jnp.float32(900.0))
    np.testing.assert_allclose(np_of(got_w), np_of(want_w), **EM_TOL)
    _gmm_close(got, want, EM_TOL)


@pytest.mark.parametrize("method", ["MAPOccDep", "MAPConst", "MLLR"])
def test_adapt_model_matches_jax(method):
    """The whole adaptModel loop (3 iterations, no bagging): the stats
    pass is the plain path on CPU tensors, no kernel launches."""
    rng = np.random.default_rng(3)
    k, d = 16, 6
    x = _gmm_data(rng, 1500, k, d) + 0.4
    w = (rng.random(1500) > 0.1).astype(np.float32)
    jw, tw = both_gmms(rng, k, d)
    tw = tw.replace(means=torch.from_numpy(_gmm_data(rng, k, k, d)))
    jw = jw.replace(means=jnp.asarray(np_of(tw.means)))
    kw = dict(method=method, nb_train_it=3, var_adapt=method == "MAPOccDep",
              mean_r=0.5 if method == "MAPConst" else 14.0)
    before = dict(launch_counts)
    got = tmap.adapt_model(torch.Generator().manual_seed(0),
                           torch.from_numpy(x), torch.from_numpy(w), tw,
                           tmap.MapCfg(**kw))
    assert launch_counts == before
    want = jmap.adapt_model(jax.random.key(0), jnp.asarray(x), jnp.asarray(w),
                            jw, jmap.MapCfg(**kw))
    _gmm_close(got, want, EM_TOL)


def test_adapt_model_takes_stats_fn():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_gmm_data(rng, 300, 8, 3))
    w = torch.ones(300)
    _, tw = both_gmms(rng, 8, 3)
    seen = []

    def stats_fn(xx, ww, g):
        seen.append(g)
        from lia_ral_tpu_torch.gmm.kernels import em_stats
        return em_stats(xx, ww, g)

    cfg = tmap.MapCfg(nb_train_it=2)
    got = tmap.adapt_model(torch.Generator(), x, w, tw, cfg,
                           stats_fn=stats_fn)
    assert len(seen) == 2 and seen[0] is tw
    _gmm_close(got, tmap.adapt_model(torch.Generator(), x, w, tw, cfg),
               UPDATE_TOL)


# -- gmm/scoring -------------------------------------------------------------

def _scoring_inputs(rng, n=300, k=32, d=6, c=5):
    x = _gmm_data(rng, n, k, d)
    world = random_gmm_np(rng, k, d)
    world = (world[0], _gmm_data(rng, k, k, d), world[2])
    clients = []
    for _ in range(c):
        w, m, ci = world
        clients.append((w, (m + 0.3 * rng.standard_normal(m.shape))
                        .astype(np.float32), ci))
    jworld, tworld = JGmm.create(*world), convert.gmm_from_numpy(*world)
    jcl = jsc.stack_gmms([JGmm.create(*g) for g in clients])
    tcl = convert.gmms_from_numpy(clients)
    return x, jworld, tworld, jcl, tcl


def _residual_cond(x, world, groups, top_k=10):
    """Per frame: the world residual log(exp(full) − exp(top)) that both
    packages take at the determine frame, and its conditioning.  A few
    f32 ulps of difference in ``full`` move the residual by
    ~8·eps·|full|/|top − full|, which is large where the top-K set holds
    nearly all the mass."""
    from lia_ral_tpu_torch.gmm.kernels import weighted_logdens
    ld = weighted_logdens(torch.as_tensor(x).reshape(-1, x.shape[-1]), world)
    full = torch.logsumexp(ld, -1)
    top = torch.logsumexp(torch.topk(ld, top_k).values, -1)
    diff = torch.clamp(top - full, max=-1e-7)
    cond = 8 * np.finfo(np.float32).eps * full.abs() / diff.abs()
    res = full + torch.log1p(-torch.exp(diff))
    g = np.asarray(groups).reshape(x.shape[:-1])
    return tuple(np.take_along_axis(np_of(v).reshape(x.shape[:-1]), g, -1)
                 for v in (cond, res))


def _llk_bound(want, cond, res):
    """|Δllk| budget of a frame whose llk is logsumexp(top-K sum,
    residual): LLK_TOL, plus the residual's conditioning times its share
    exp(res − llk) of the frame's likelihood (a stale top-K set under
    worldDecime > 1 can leave the residual nearly all of it)."""
    share = np.minimum(np.exp(res - want), 1.0)
    return LLK_TOL["atol"] + LLK_TOL["rtol"] * np.abs(want) + cond * share


def _assert_llk_close(got, want, cond, res):
    got, want = np_of(got), np_of(want)
    assert (np.abs(got - want) <= _llk_bound(want, cond, res)).all()


@pytest.mark.parametrize("decime", [1, 3])
@pytest.mark.parametrize("residual", [True, False], ids=["residual",
                                                          "no_residual"])
def test_top_k_llk_matches_jax(decime, residual):
    """Per-frame llks within LLK_TOL, widened by ``_llk_bound`` on the
    frames whose residual is ill-conditioned (a property of the JAX
    package's formula, ROADMAP queue 3); the determine frames of the
    world hold LLK_TOL itself."""
    rng = np.random.default_rng(5)
    x, jworld, tworld, jcl, tcl = _scoring_inputs(rng)
    groups = jsc.decime_groups([120, 77, 103], decime)
    np.testing.assert_array_equal(
        tsc.decime_groups([120, 77, 103], decime), groups)
    jwl, jcll = jsc.top_k_llk(jnp.asarray(x), jworld, jcl,
                              jnp.asarray(groups), top_k=10,
                              use_residual=residual)
    twl, tcll = tsc.top_k_llk(torch.from_numpy(x), tworld, tcl,
                              torch.from_numpy(groups), top_k=10,
                              use_residual=residual)
    # no true ties in the world densities: the same top-10 sets
    from lia_ral_tpu_torch.gmm.kernels import weighted_logdens
    ld = weighted_logdens(torch.from_numpy(x), tworld)
    _, jidx = jax.lax.top_k(jnp.asarray(np_of(ld)), 10)
    tidx = torch.topk(ld, 10).indices
    assert (np.sort(np_of(jidx), -1) == np.sort(np_of(tidx), -1)).all()
    det = groups == np.arange(x.shape[0])
    np.testing.assert_allclose(np_of(twl)[det], np_of(jwl)[det], **LLK_TOL)
    cond, res = _residual_cond(x, tworld, groups)
    if not residual:
        cond = np.zeros_like(cond)
    _assert_llk_close(twl, jwl, cond, res)
    _assert_llk_close(tcll, jcll, cond[None, :], res[None, :])
    assert tcll.shape == (5, x.shape[0])


def test_top_k_clamps_to_world_size():
    rng = np.random.default_rng(6)
    x, jworld, tworld, jcl, tcl = _scoring_inputs(rng, k=8)
    g = np.arange(x.shape[0], dtype=np.int32)
    want = jsc.compute_test_llr(jnp.asarray(x), jnp.ones(x.shape[0]), jworld,
                                jcl, jnp.asarray(g), top_k=20)
    got = tsc.compute_test_llr(torch.from_numpy(x), torch.ones(x.shape[0]),
                               tworld, tcl, torch.from_numpy(g), top_k=20)
    np.testing.assert_allclose(np_of(got), np_of(want), **LLR_TOL)


def test_compute_test_llr_batch_matches_per_line_and_jax():
    """B lines against one client set: the batched block equals the
    per-line form line by line (atol 1e-6), and the JAX package's vmapped
    batch within LLR_TOL plus the weighted mean of ``_llk_bound``."""
    rng = np.random.default_rng(7)
    _, jworld, tworld, jcl, tcl = _scoring_inputs(rng)
    b, t, d = 4, 160, 6
    xb = np.stack([_gmm_data(rng, t, 32, d) for _ in range(b)])
    wb = (rng.random((b, t)) > 0.2).astype(np.float32)
    wb[1, 100:] = 0.0                              # a padded short line
    gb = np.stack([tsc.decime_groups([t], dec) for dec in (1, 2, 3, 1)])
    got = tsc.compute_test_llr_batch(torch.from_numpy(xb),
                                     torch.from_numpy(wb), tworld, tcl,
                                     torch.from_numpy(gb), top_k=10)
    assert got.shape == (b, 5)
    for i in range(b):
        one = tsc.compute_test_llr(torch.from_numpy(xb[i]),
                                   torch.from_numpy(wb[i]), tworld, tcl,
                                   torch.from_numpy(gb[i]), top_k=10)
        np.testing.assert_allclose(np_of(got[i]), np_of(one), rtol=0,
                                   atol=1e-6)
    want = jsc.compute_test_llr_batch(jnp.asarray(xb), jnp.asarray(wb),
                                      jworld, jcl, jnp.asarray(gb), top_k=10)
    # the per-frame budgets of the world and the clients, averaged as the
    # LLR averages the frames
    cond, res = _residual_cond(xb, tworld, gb)
    flat_groups = (gb + np.arange(b)[:, None] * t).reshape(-1)
    wl, cl = jsc.top_k_llk(jnp.asarray(xb.reshape(-1, d)), jworld, jcl,
                           jnp.asarray(flat_groups), top_k=10)
    frame_bound = (_llk_bound(np_of(wl).reshape(b, t), cond, res)[:, None]
                   + _llk_bound(np_of(cl).reshape(5, b, t).transpose(1, 0, 2),
                                cond[:, None], res[:, None]))
    line_bound = np.sum(frame_bound * wb[:, None], -1) / np.sum(wb, -1)[:, None]
    assert (np.abs(np_of(got) - np_of(want)) <= LLR_TOL["atol"]
            + line_bound).all()
    # lines without decimation hold LLR_TOL itself
    np.testing.assert_allclose(np_of(got)[[0, 3]], np_of(want)[[0, 3]],
                               **LLR_TOL)


def test_client_equal_to_world_scores_zero():
    rng = np.random.default_rng(8)
    x, _, tworld, _, _ = _scoring_inputs(rng)
    same = tsc.stack_gmms([tworld, tworld])
    llr = tsc.compute_test_llr(torch.from_numpy(x), torch.ones(x.shape[0]),
                               tworld, same, top_k=10)
    assert float(llr.abs().max()) < 5e-5


@pytest.mark.parametrize("tops", [(None, None), (5, 7)],
                         ids=["all", "top5x7"])
def test_likelihood_gd_matches_jax(tops):
    rng = np.random.default_rng(9)
    jd, td = both_gmms(rng, 12, 4)
    jm, tm = both_gmms(rng, 16, 4)
    got = tsc.likelihood_gd(td, tm, *tops)
    want = jsc.likelihood_gd(jd, jm, *tops)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_stack_and_decision_helpers():
    rng = np.random.default_rng(10)
    gmms = [random_gmm_np(rng, 4, 3) for _ in range(3)]
    stacked = convert.gmms_from_numpy(gmms)
    by_list = tsc.stack_gmms([convert.gmm_from_numpy(*g) for g in gmms])
    assert stacked.means.shape == (3, 4, 3) and stacked.weights.shape == (3, 4)
    for f in ("weights", "means", "cov_inv"):
        assert torch.equal(getattr(stacked, f), getattr(by_list, f))
    llr = np.array([-0.5, 0.0, 0.25], np.float32)
    np.testing.assert_array_equal(np_of(tsc.set_decision(llr, 0.0)),
                                  np_of(jsc.set_decision(llr, 0.0)))


# -- backend/norm ------------------------------------------------------------

def _norm_inputs(rng, m=6, t=8, z=10, i=7, masked=False):
    """Score matrices with ties and an even impostor count; masks drop a
    ragged set of trials (never all of an entity's)."""
    r = lambda *s: np.round(rng.standard_normal(s), 1).astype(np.float32)
    mats = dict(s=r(m, t), zs=r(m, z), ts=r(i, t), cs=r(i, z))
    masks = {}
    if masked:
        for key in ("zs", "ts", "cs"):
            mk = rng.random(mats[key].shape) > 0.3
            mk[:, 0] = mk[0, :] = True
            masks[key] = mk
            mats[key] = np.where(mk, mats[key], np.nan).astype(np.float32)
    return mats, masks


NORM_KW = {
    "mean": dict(use_median=False),
    "median": dict(use_median=True),
    "mean_trim": dict(use_median=False, percent_h=0.2, percent_l=0.1),
    "median_trim": dict(use_median=True, percent_h=0.1, percent_l=0.25),
}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("kw", list(NORM_KW))
@pytest.mark.parametrize("fn", ["znorm", "tnorm", "ztnorm", "tznorm"])
def test_norms_match_jax(fn, kw, masked):
    rng = np.random.default_rng(11)
    mats, masks = _norm_inputs(rng, masked=masked)
    kw = NORM_KW[kw]

    def args(lib):
        arr = (jnp.asarray if lib is jnorm else torch.from_numpy)
        a = {k: arr(np.nan_to_num(v, nan=0.0)) for k, v in mats.items()}
        mk = {k: arr(v) for k, v in masks.items()}
        if fn == "znorm":
            return (a["s"], a["zs"]), dict(impostor_mask=mk.get("zs"))
        if fn == "tnorm":
            return (a["s"], a["ts"]), dict(impostor_mask=mk.get("ts"))
        return ((a["s"], a["zs"], a["ts"], a["cs"]),
                dict(z_mask=mk.get("zs"), t_mask=mk.get("ts"),
                     cross_mask=mk.get("cs")))

    pos, kwm = args(tnorm)
    got = getattr(tnorm, fn)(*pos, **kw, **kwm)
    pos, kwm = args(jnorm)
    want = getattr(jnorm, fn)(*pos, **kw, **kwm)
    np.testing.assert_allclose(np_of(got), np_of(want), **NORM_TOL)


@pytest.mark.parametrize("n", [6, 7], ids=["even", "odd"])
def test_norm_median_matches_jnp_median(n):
    """jnp.median averages the two middle values of an even count;
    torch.median would take the lower one."""
    rng = np.random.default_rng(12)
    s = np.round(rng.standard_normal((3, n)), 1).astype(np.float32)
    mu, sd = tnorm._stats(torch.from_numpy(s), 1, use_median=True)
    jmu, jsd = jnorm._stats(jnp.asarray(s), 1, use_median=True)
    np.testing.assert_allclose(np_of(mu), np.median(s, axis=1), rtol=1e-6)
    np.testing.assert_allclose(np_of(mu), np_of(jmu), rtol=1e-6)
    np.testing.assert_allclose(np_of(sd), np_of(jsd), rtol=1e-6)
    if n % 2 == 0:
        assert not torch.equal(mu, torch.median(torch.from_numpy(s), 1).values)


# -- frontend/normfeat --------------------------------------------------------

def _feat_inputs(rng, n=600, d=5):
    x = (rng.standard_normal((n, d)) * 3 + 2).astype(np.float32)
    w = (rng.random(n) > 0.15).astype(np.float32)
    return x, w


@pytest.mark.parametrize("opts", [{}, {"cms_only": True},
                                  {"var_only": True}],
                         ids=["cmvn", "cms_only", "var_only"])
def test_cmvn_global_matches_jax(opts):
    x, w = _feat_inputs(np.random.default_rng(13))
    got = tnf.cmvn_global(torch.from_numpy(x), torch.from_numpy(w), **opts)
    want = jnf.cmvn_global(jnp.asarray(x), jnp.asarray(w), **opts)
    np.testing.assert_allclose(np_of(got), np_of(want), **FEAT_TOL)


def test_cmvn_segmental_matches_jax():
    rng = np.random.default_rng(14)
    x, w = _feat_inputs(rng)
    ids = np.repeat(np.arange(4), 150).astype(np.int32)
    got = tnf.cmvn_segmental(torch.from_numpy(x), torch.from_numpy(ids),
                             torch.from_numpy(w), 4)
    want = jnf.cmvn_segmental(jnp.asarray(x), jnp.asarray(ids),
                              jnp.asarray(w), 4)
    np.testing.assert_allclose(np_of(got), np_of(want), **FEAT_TOL)


@pytest.mark.parametrize("fallback", [True, False], ids=["global_fallback",
                                                         "no_fallback"])
def test_cmvn_window_matches_jax(fallback):
    x, w = _feat_inputs(np.random.default_rng(15))
    got = tnf.cmvn_window(torch.from_numpy(x), torch.from_numpy(w), 51,
                          fallback)
    want = jnf.cmvn_window(jnp.asarray(x), jnp.asarray(w), 51, fallback)
    np.testing.assert_allclose(np_of(got), np_of(want), **FEAT_TOL)


def test_feature_warping_matches_jax():
    x, w = _feat_inputs(np.random.default_rng(16), n=400)
    got = tnf.feature_warping(torch.from_numpy(x), torch.from_numpy(w), 61,
                              chunk=64)
    want = jnf.feature_warping(jnp.asarray(x), jnp.asarray(w), 61, chunk=64)
    np.testing.assert_allclose(np_of(got), np_of(want), **FEAT_TOL)


def test_normfeat_batch_forms_match_jax():
    """(B,T,D) batches of zero-weight-padded files through the batch
    forms, against the JAX package's vmapped ones."""
    rng = np.random.default_rng(17)
    b, t, d = 3, 256, 4
    x = (rng.standard_normal((b, t, d)) * 2 - 1).astype(np.float32)
    w = (rng.random((b, t)) > 0.1).astype(np.float32)
    w[2, 180:] = 0.0
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    np.testing.assert_allclose(np_of(tnf.cmvn_global_batch(xt, wt)),
                               np_of(jnf.cmvn_global_batch(xj, wj)),
                               **FEAT_TOL)
    np.testing.assert_allclose(np_of(tnf.cmvn_window_batch(xt, wt, 31)),
                               np_of(jnf.cmvn_window_batch(xj, wj, 31)),
                               **FEAT_TOL)
    half = 15
    xp = np.concatenate([x[:, :half][:, ::-1], x, x[:, -half:][:, ::-1]], 1)
    wp = np.concatenate([w[:, :half][:, ::-1], w, w[:, -half:][:, ::-1]], 1)
    got = tnf.feature_warping_batch(torch.from_numpy(xp.copy()),
                                    torch.from_numpy(wp.copy()), 31, 64)
    want = jnf.feature_warping_batch(jnp.asarray(xp), jnp.asarray(wp), 31, 64)
    np.testing.assert_allclose(np_of(got), np_of(want), **FEAT_TOL)


def test_feature_mapping_matches_jax():
    rng = np.random.default_rng(18)
    jc, tc = both_gmms(rng, 8, 5)
    jr, tr = both_gmms(rng, 8, 5)
    x, _ = _feat_inputs(rng, n=200)
    got = tnf.feature_mapping(torch.from_numpy(x), tc, tr)
    want = jnf.feature_mapping(jnp.asarray(x), jc, jr)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-5)


# -- frontend/energy_vad ------------------------------------------------------

@pytest.mark.parametrize("mode", ["meanStd", "weight"])
def test_energy_detector_matches_jax(mode):
    """The 1-D EM (plain K1 path on CPU tensors, K=3, D=1) and the
    threshold: the same speech mask, the same fixed init and the same
    weight-mode histogram threshold."""
    rng = np.random.default_rng(19)
    n = 2000
    energy = np.where(rng.random(n) < 0.3, rng.normal(-3, 0.5, n),
                      rng.normal(2, 1.0, n)).astype(np.float32)
    w = (rng.random(n) > 0.05).astype(np.float32)
    kw = dict(threshold_mode=mode, alpha=0.4)
    before = dict(launch_counts)
    got = tvad.energy_detector(energy, w, tvad.EnergyDetectorCfg(**kw))
    assert launch_counts == before
    want = jvad.energy_detector(energy, w, jvad.EnergyDetectorCfg(**kw))
    np.testing.assert_array_equal(got, want)
    assert 0.5 < got.mean() < 0.8
    _gmm_close(tvad.energy_mixture_init(3), jvad.energy_mixture_init(3),
               UPDATE_TOL)
    assert tvad.weight_mode_threshold(energy, w, 0.6) \
        == jvad.weight_mode_threshold(energy, w, 0.6)
