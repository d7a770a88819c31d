"""The port's supervector, SVM and utility modules against the JAX
package's, on the same numpy inputs.

Tolerances, per quantity:

* supervector functions: 1e-6 of the array's scale (f32 products; the
  NAP projection is a matmul pair);
* ``train_nap_subspace``: the row-space projector UᵀU within 1e-5, on
  data with a clear singular-value gap at the rank (signs and bases of an
  SVD are the solver's);
* ``kernel_matrix``: 1e-6 of scale (rbf: exp of an f32 distance);
* the plain dual solve against the JAX ``_dual_solve`` at the JAX parity
  test's problem (3 + 60 vectors, d = 40; 500 FISTA steps): α within
  1e-4·C (measured 2.7e-7·C linear, 1.1e-5·C poly, 5.6e-6·C rbf, 2.9e-6·C
  linear with targetPenalty 10: XLA and torch sum the matvecs in another
  order and 500 momentum steps carry it), decisions within 1e-5 of their
  scale (measured ≤ 1.7e-7), the dual objective within 1e-3 relative of
  the SMO reference of tests/test_svm_parity.py;
* ``poly_expand``, ``glds_expand_mean``: 1e-6 relative (the same f32
  products in the same order; the mean sums in another order);
* ``gmm_tokenize`` and the numpy utilities (scores, labels, n-grams, the
  sequence-extractor tree): equal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lia_ral_tpu.backend import supervector as jsv
from lia_ral_tpu.backend import svm as jsvm
from lia_ral_tpu.gmm.model import GmmDiag as JGmm
from lia_ral_tpu.io.labels import Segment as JSegment
from lia_ral_tpu.io.nist import ScoreLine as JScoreLine
from lia_ral_tpu import utils as jutils
from lia_ral_tpu.utils import polyexp as jpoly
from lia_ral_tpu.utils import seqtree as jseq

from lia_ral_tpu_torch.backend import supervector as tsv
from lia_ral_tpu_torch.backend import svm as tsvm
from lia_ral_tpu_torch.convert import gmm_from_numpy
from lia_ral_tpu_torch.io.labels import Segment as TSegment
from lia_ral_tpu_torch.io.nist import ScoreLine as TScoreLine
from lia_ral_tpu_torch import utils as tutils
from lia_ral_tpu_torch.utils import polyexp as tpoly
from lia_ral_tpu_torch.utils import seqtree as tseq

from _torch_parity import assert_close_scaled, np_of, projector, random_gmm_np
from test_svm_parity import _gmm_sv_problem, dual_objective, smo_reference


def _gmm_pair(rng, k=6, d=4):
    w, m, ci = random_gmm_np(rng, k, d)
    return JGmm.create(w, m, ci), gmm_from_numpy(w, m, ci)


# -- supervectors ---------------------------------------------------------------

def test_supervector_functions_match_jax(rng):
    jw, tw = _gmm_pair(rng)
    jc, tc = _gmm_pair(rng)
    u = np.linalg.qr(rng.standard_normal((24, 3)))[0].T.astype(np.float32)
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    vecs = rng.standard_normal((5, 24)).astype(np.float32)
    pairs = [
        (jsv.model_to_sv(jc), tsv.model_to_sv(tc)),
        (jsv.sv_to_model(jsv.model_to_sv(jc) + 1.0, jw).means,
         tsv.sv_to_model(tsv.model_to_sv(tc) + 1.0, tw).means),
        (jsv.project_on_subspace(jnp.asarray(vecs), ju),
         tsv.project_on_subspace(torch.from_numpy(vecs), tu)),
        (jsv.compute_nap(jc, ju).means, tsv.compute_nap(tc, tu).means),
        (jsv.nap_project_vectors(jnp.asarray(vecs), ju),
         tsv.nap_project_vectors(torch.from_numpy(vecs), tu)),
        (jsv.fisher_weight_vector(jw, jc), tsv.fisher_weight_vector(tw, tc)),
        (jsv.kl_vector(jc), tsv.kl_vector(tc)),
        (jsv.get_supervector("KL", jw, jc), tsv.get_supervector("KL", tw, tc)),
        (jsv.get_supervector("SVMUBM", jw, jc),
         tsv.get_supervector("SVMUBM", tw, tc)),
    ]
    for i, (want, got) in enumerate(pairs):
        assert_close_scaled(got, want, 1e-6, err_msg=str(i))
    # NAP leaves nothing along U
    np.testing.assert_allclose(
        u @ np_of(tsv.model_to_sv(tsv.compute_nap(tc, tu))), 0.0, atol=1e-5)
    with pytest.raises(ValueError, match="KL|SVMUBM"):
        tsv.get_supervector("nope", tw, tc)


def test_train_nap_subspace_matches_jax(rng):
    """Two planted channel directions of variance 9 and 4 over a 0.01
    noise floor: a clear gap at rank 2."""
    d, n_spk, sess, rank = 30, 8, 6, 2
    chan = np.linalg.qr(rng.standard_normal((d, rank)))[0].T
    spk = rng.standard_normal((n_spk, d)) * 3
    vecs, ids = [], []
    for s in range(n_spk):
        for _ in range(sess):
            vecs.append(spk[s] + rng.standard_normal(rank) * [3.0, 2.0] @ chan
                        + rng.standard_normal(d) * 0.1)
            ids.append(s)
    v = np.stack(vecs).astype(np.float32)
    ids = np.asarray(ids)
    want = jsv.train_nap_subspace(jnp.asarray(v), jnp.asarray(ids), n_spk,
                                  rank)
    got = tsv.train_nap_subspace(torch.from_numpy(v), torch.from_numpy(ids),
                                 n_spk, rank)
    assert got.shape == (rank, d)
    np.testing.assert_allclose(np_of(got) @ np_of(got).T, np.eye(rank),
                               atol=1e-5)
    np.testing.assert_allclose(projector(got), projector(want), atol=1e-5)
    np.testing.assert_allclose(projector(got), projector(chan), atol=2e-2)


# -- SVM ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "poly", "rbf"])
def test_kernel_matrix_matches_jax(rng, kind):
    x = rng.standard_normal((7, 12)).astype(np.float32)
    z = rng.standard_normal((5, 12)).astype(np.float32)
    want = jsvm.kernel_matrix(jnp.asarray(x), jnp.asarray(z), kind, 3, 0.0,
                              0.5)
    got = tsvm.kernel_matrix(torch.from_numpy(x), torch.from_numpy(z), kind,
                             3, 0.0, 0.5)
    assert_close_scaled(got, want, 1e-6)
    with pytest.raises(ValueError, match="unknown kernel"):
        tsvm.kernel_matrix(torch.from_numpy(x), torch.from_numpy(z), "sig")


@pytest.mark.parametrize("kind,penalty", [("linear", None), ("poly", None),
                                          ("rbf", None), ("linear", 10.0)],
                         ids=["linear", "poly", "rbf", "linear_penalty"])
def test_plain_dual_solve_matches_jax(kind, penalty):
    """The plain route of the port's ``_dual_solve`` against the JAX
    ``_dual_solve`` (and the SMO reference) on the JAX parity test's
    problem, at the default 500 FISTA steps."""
    rng = np.random.default_rng(17)
    x, y = _gmm_sv_problem(rng)
    c = jsvm.default_c(x)
    assert tsvm.default_c(x) == c
    c_vec = np.full(y.shape, c, np.float32)
    if penalty:
        c_vec[y > 0] *= penalty
    degree = 2 if kind == "poly" else 1
    kj = jsvm.kernel_matrix(jnp.asarray(x), jnp.asarray(x), kind, degree)
    want = np.asarray(jsvm._dual_solve(kj, jnp.asarray(y),
                                       jnp.asarray(c_vec)))
    kt = tsvm.kernel_matrix(torch.from_numpy(x), torch.from_numpy(x), kind,
                            degree)
    got = np_of(tsvm._dual_solve(kt, torch.from_numpy(y),
                                 torch.from_numpy(c_vec)))
    assert np.abs(got - want).max() <= 1e-4 * c
    k64 = np.asarray(kj, np.float64)
    assert_close_scaled(k64 @ (got * y), k64 @ (want * y), 1e-5)
    a_smo, _ = smo_reference(k64, y.astype(np.float64),
                             c_vec.astype(np.float64))
    obj_smo = dual_objective(k64, y, a_smo)
    assert abs(dual_objective(k64, y, got) - obj_smo) \
        <= 1e-3 * max(abs(obj_smo), 1.0)
    # a batch of problems on the leading axis solves each alone (the
    # batched matvec may sum in another order)
    both = tsvm.dual_solve_reference(torch.stack([kt, kt]),
                                     torch.from_numpy(np.stack([y, y])),
                                     torch.from_numpy(np.stack([c_vec,
                                                                c_vec])))
    np.testing.assert_allclose(np_of(both[1]), got, rtol=0, atol=1e-4 * c)


def test_svm_train_matches_jax_at_2000_iterations():
    """svm_train end to end (the JAX SMO parity test's problem, rbf, 2000
    steps): bias, support and decisions on held-out vectors."""
    rng = np.random.default_rng(17)
    x, y = _gmm_sv_problem(rng)
    test = _gmm_sv_problem(rng)[0][:10]
    want = jsvm.svm_train(x, y, kind="rbf", n_iter=2000)
    got = tsvm.svm_train(torch.from_numpy(x), y, kind="rbf", n_iter=2000)
    assert got.kind == "rbf" and got.support.dtype == np.float32
    np.testing.assert_array_equal(got.support, want.support)
    np.testing.assert_allclose(got.alpha_y, want.alpha_y,
                               atol=1e-4 * jsvm.default_c(x))
    assert abs(got.bias - want.bias) <= 1e-4
    assert_close_scaled(got.decision(torch.from_numpy(test)),
                        want.decision(jnp.asarray(test)), 1e-4)


def test_dual_solve_cuda_refuses_cpu_tensors():
    k = torch.eye(3)
    with pytest.raises(ValueError, match="no kernel"):
        tsvm.dual_solve_cuda(k, torch.ones(3), torch.ones(3))


# -- polynomial expansion and tokenizer -----------------------------------------

def test_poly_expand_and_glds_mean_match_jax(rng):
    x = rng.standard_normal((50, 5)).astype(np.float32)
    w = (rng.random(50) > 0.3).astype(np.float32)
    assert tpoly.poly_expansion_size(39) == 11480
    np.testing.assert_array_equal(tpoly._index_triples(5),
                                  jpoly._index_triples(5))
    e = tpoly.poly_expand(torch.from_numpy(x))
    assert e.shape == (50, tpoly.poly_expansion_size(5))
    np.testing.assert_allclose(np_of(e), np.asarray(
        jpoly.poly_expand(jnp.asarray(x))), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        np_of(tpoly.glds_expand_mean(torch.from_numpy(x),
                                     torch.from_numpy(w))),
        np.asarray(jpoly.glds_expand_mean(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)


def test_gmm_tokenize_and_confusion_match_jax(rng):
    jg, tg = _gmm_pair(rng, 16, 6)
    x = rng.standard_normal((300, 6)).astype(np.float32)
    want = jutils.gmm_tokenize(jnp.asarray(x), jg)
    got = tutils.gmm_tokenize(torch.from_numpy(x), tg)
    np.testing.assert_array_equal(got, want)
    b = rng.integers(0, 16, 300)
    np.testing.assert_array_equal(tutils.confusion_matrix(got, b, 16),
                                  jutils.confusion_matrix(want, b, 16))


# -- the numpy utilities: equal outputs -------------------------------------------

def _score_lines(cls, rng):
    return [cls("M", f"m{i % 4}", "-", f"s{i // 4}",
                float(rng.standard_normal()))
            for i in range(40)]


def test_score_utilities_equal_jax(rng):
    seed = int(rng.integers(1 << 30))
    jl = _score_lines(JScoreLine, np.random.default_rng(seed))
    tl = _score_lines(TScoreLine, np.random.default_rng(seed))
    jl2 = _score_lines(JScoreLine, np.random.default_rng(seed + 1))
    tl2 = _score_lines(TScoreLine, np.random.default_rng(seed + 1))

    def fmt(lines):
        return [ln.format() for ln in lines]

    assert fmt(tutils.scoring_decisions(tl, 0.1)) \
        == fmt(jutils.scoring_decisions(jl, 0.1))
    assert fmt(tutils.max_score_identification(tl)) \
        == fmt(jutils.max_score_identification(jl))
    assert fmt(tutils.fuse_scores([tl, tl2], [0.3, 0.7])) \
        == fmt(jutils.fuse_scores([jl, jl2], [0.3, 0.7]))
    s = np.array([ln.score for ln in tl])
    np.testing.assert_array_equal(tutils.score_warp(s, nb_bins=20),
                                  jutils.score_warp(s, nb_bins=20))
    for a, b in zip(tutils.histogram(s, 7), jutils.histogram(s, 7)):
        np.testing.assert_array_equal(a, b)


def test_label_utilities_equal_jax():
    def segs(cls):
        return [[cls(0.0, 0.10, "speech"), cls(0.35, 0.6, "speech")],
                [cls(0.12, 0.20, "speech"), cls(0.5, 0.9, "speech"),
                 cls(0.95, 0.97, "speech")]]

    for mode in ("union", "intersection", "vote"):
        kw = dict(frame_length=0.01, mode=mode, close_gap=3, drop_short=2)
        assert tutils.fuse_label_files(segs(TSegment), 100, **kw) \
            == [TSegment(s.begin, s.end, s.label)
                for s in jutils.fuse_label_files(segs(JSegment), 100, **kw)]
    kw = dict(min_duration=0.1, begin=0.05, end=0.8, labels=["speech"])
    assert tutils.time_cluster_filter(segs(TSegment)[1], **kw) \
        == [TSegment(s.begin, s.end, s.label)
            for s in jutils.time_cluster_filter(segs(JSegment)[1], **kw)]


def test_ngram_utilities_equal_jax(rng, tmp_path):
    a = [str(s) for s in rng.integers(0, 5, 300)]
    b = [str(s) for s in rng.integers(0, 5, 300)]
    assert tutils.ngram_counts(a, 3) == jutils.ngram_counts(a, 3)
    tm = {"A": tutils.NGramModel.train([a], 2),
          "B": tutils.NGramModel.train([b], 2)}
    jm = {"A": jutils.NGramModel.train([a], 2),
          "B": jutils.NGramModel.train([b], 2)}
    assert tutils.sequence_decode(a[:60], tm) \
        == jutils.sequence_decode(a[:60], jm)
    path = str(tmp_path / "cb.3gram")
    with open(path, "w") as f:
        for gram, c in jutils.ngram_counts(a, 3).most_common(12):
            f.write(" ".join(gram) + f" {c}\n")
    tcb = tutils.read_ngram_codebook(path, 3, 8)
    assert tcb == jutils.read_ngram_codebook(path, 3, 8)
    syms = [int(s) for s in a]
    assert tutils.label_ngram(syms, tcb, 3) \
        == jutils.label_ngram(syms, tcb, 3)


def test_sequence_extractor_tree_equals_jax(rng, tmp_path):
    """ngram files of orders 1-3 from one symbol stream → the common-part
    tree → an equal-probability carve of 4 output symbols: the same info,
    the same saved decoder text and the same decoding in both packages."""
    stream = [str(s) for s in rng.integers(0, 6, 500)]
    base = str(tmp_path / "ngram")
    for order in (1, 2, 3):
        with open(f"{base}{order}.dta", "w") as f:
            for gram, c in sorted(jutils.ngram_counts(stream, order).items()):
                f.write(" ".join(gram) + f" {c}\n")
    out = {}
    for name, mod in (("jax", jseq), ("torch", tseq)):
        tree = mod.CommonPartTree.from_ngram_files(base, ".dta", 3)
        dec, info = mod.sequence_extractor(tree, 6, 4)
        path = str(tmp_path / f"dec.{name}")
        with open(path, "w") as f:
            dec.save(f)
        with open(path) as f:
            loaded = mod.SequenceDecoder.load(f)
        out[name] = (info, open(path).read(),
                     loaded.decode([int(s) for s in stream[:80]]))
    assert out["torch"] == out["jax"]


def test_logging_honours_config_keys():
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.utils import logging as tlog

    tlog.configure_from(Config({"verbose": "true", "verboseLevel": 2}))
    assert tlog.verbose and tlog.verbose_level == 2
    assert tlog.get_logger().getEffectiveLevel() == 20
    assert tlog.get_logger("x").name == "lia_ral_tpu_torch.x"
    tlog.configure_from(Config({}))
    assert not tlog.verbose and tlog.get_logger().getEffectiveLevel() == 30


def test_profile_trace_writes_named_spans(tmp_path):
    """``profile_trace`` (the counterpart of the JAX package's
    jax.profiler trace) writes a Chrome trace of its block, and a span of
    ``span`` appears in it and in the profiler's sums by name."""
    import json

    from lia_ral_tpu_torch.gmm import cuda_kernels as ck
    from lia_ral_tpu_torch.utils import logging as tlog

    _, tg = _gmm_pair(np.random.default_rng(3), 4, 3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (40, 3)).astype(np.float32))
    with tlog.profile_trace(str(tmp_path / "tr")) as prof:
        with tlog.span("em_stats_fused[exp_mode=fast2]"):
            ck.em_stats_fused(x, torch.ones(40), tg, exp_mode="fast2")
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "em_stats_fused[exp_mode=fast2]" in names
    assert "em_stats_fused[exp_mode=fast2]" in {
        e.key for e in prof.key_averages()}
