"""The port's CLI chain TrainWorld → TotalVariability → IvExtractor →
IvTest (cosine) against the JAX package's, plus the tools' plumbing.

Both packages' ``tools.*.main`` run in their own temp directory on the
same feature and label files (a tests/test_tools_iv.py-sized corpus:
K=16, D=8, R=4, 12 speakers).  Neither side draws random numbers:
TrainWorld starts from one shared ``inputWorldFilename`` with
``baggedFrameProbability=1``, and TotalVariability's ``init_t`` is
patched here, on both sides, to return the same T.

The JAX package's stats paths on the CPU ignore ``fastStats`` (they run
XLA whatever the key says), so for the fastStats chain the JAX side's
stats are routed through its Pallas kernels in interpret mode with
``stats_pass="bf16nx"``, as the JAX suite's own tests run them, and with
f32 logits (``mxu_precision="highest"``): the port's kernel and plain
version compute f32 logits, while the TPU's 3-pass bf16 logit product,
emulated in interpret mode, drops its lo·lo term, which moves p enough
to flip its bf16 rounding (measured on this corpus: the S/F gap to the
port grows from ~5e-6 to ~4e-5 of max, against the tier's own 1.6e-4).

Tolerances (stated per array, atol scaled by the array's max): UBM
parameters rtol 1e-4 (f32 roundoff of the stats through 3 M-steps);
T, i-vectors and scores 1e-3·max|·| — the budget chip_smoke.py holds
kernel against plain i-vectors to.  The fastStats chain: UBM rtol 5e-3
and T 2e-3, because a bf16 rounding of p or xa·s flips on an f32-level
difference between the two frameworks' sums, and the variance
Σγx²/n − μ² amplifies that by cancellation (measured 1.8e-3 on cov_inv
and 9e-4 on T, against the tier's own effect of 8.7e-3 and 5.5e-3 —
fastStats chain against default chain in either package).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lia_ral_tpu.config import Config as JConfig
from lia_ral_tpu.fa import stats as jstats
from lia_ral_tpu.fa import tv as jtv
from lia_ral_tpu.gmm import em as jem
from lia_ral_tpu.gmm.model import GmmDiag as JGmm
from lia_ral_tpu.gmm.pallas_kernels import bw_stats_fused as jbw_fused
from lia_ral_tpu.gmm.pallas_kernels import em_stats_fused as jem_fused
from lia_ral_tpu.io.gmm_io import read_gmm_file
from lia_ral_tpu.io.matrix import read_matrix_file
from lia_ral_tpu.io.nist import read_nist_scores
from lia_ral_tpu.tools import iv_extractor as j_iv_extractor
from lia_ral_tpu.tools import iv_test as j_iv_test
from lia_ral_tpu.tools import total_variability as j_total_variability
from lia_ral_tpu.tools import train_world as j_train_world

from lia_ral_tpu_torch import __main__ as tmain
from lia_ral_tpu_torch.config import Config as TConfig
from lia_ral_tpu_torch.fa import tv as ttv
from lia_ral_tpu_torch.gmm.cuda_kernels import launch_counts
from lia_ral_tpu_torch.io.features import write_feature_file
from lia_ral_tpu_torch.io.labels import Segment, write_label_file
from lia_ral_tpu_torch.io.lists import write_xlist
from lia_ral_tpu_torch.tools import common as tcommon
from lia_ral_tpu_torch.tools import iv_extractor as t_iv_extractor
from lia_ral_tpu_torch.tools import iv_test as t_iv_test
from lia_ral_tpu_torch.tools import total_variability as t_total_variability
from lia_ral_tpu_torch.tools import train_world as t_train_world

from _torch_parity import random_gmm_np

DIM, K, RANK, N_SPK, SESS = 8, 16, 4, 12, 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Feature/label files and lists (shared), the init GMM and the T the
    patched ``init_t`` returns."""
    d = str(tmp_path_factory.mktemp("torch_ivchain"))
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((K, DIM)) * 2
    spk_shift = rng.standard_normal((N_SPK, DIM)) * 0.8

    def utt(spk, n=400):
        comp = rng.integers(0, K, n)
        x = (centers[comp] + spk_shift[spk]
             + rng.standard_normal((n, DIM)) * 0.5)
        return x.astype(np.float32)

    def write(name, x, tail=0):
        write_feature_file(os.path.join(d, name + ".prm"), x, fmt="SPRO4")
        if tail:        # a label file that drops a ragged tail
            end = (x.shape[0] - tail - 1) * 0.01
            write_label_file(os.path.join(d, name + ".lbl"),
                             [Segment(0.0, end, "speech")])

    write("bg", np.concatenate([utt(s) for s in range(N_SPK)]), tail=37)
    dev, enroll, tests = [], [], []
    for s in range(N_SPK):
        for j in range(SESS):
            name = f"dev_s{s}_{j}"
            write(name, utt(s), tail=(s * 7 + j * 3) % 50)
            dev.append(name)
        write(f"enroll_s{s}", utt(s))
        enroll.append((f"model{s}", f"enroll_s{s}"))
        write(f"test_s{s}", utt(s), tail=11)
        tests.append(f"test_s{s}")
    write_xlist(os.path.join(d, "bg.lst"), [["bg"]])
    write_xlist(os.path.join(d, "tv.ndx"), [[n] for n in dev])
    write_xlist(os.path.join(d, "all.ndx"),
                [[n] for n in dev + [e for _, e in enroll] + tests])
    write_xlist(os.path.join(d, "targets.ndx"), [[m, f] for m, f in enroll])
    write_xlist(os.path.join(d, "trials.ndx"),
                [[t] + [m for m, _ in enroll] for t in tests])
    w, m, ci = random_gmm_np(rng, K, DIM)
    JGmm.create(w, m * 2.0, ci).save(os.path.join(d, "init.gmm"))
    t0 = (rng.standard_normal((RANK, K, DIM)) * 0.5).astype(np.float32)
    return d, t0


def _config(cls, d, work, fast_stats, **extra):
    cfg = cls({
        "featureFilesPath": d + "/", "labelFilesPath": d + "/",
        "lstPath": d + "/", "mixtureFilesPath": work + "/",
        "matrixFilesPath": work + "/", "saveVectorFilesPath": work + "/",
        "loadVectorFilesPath": work + "/",
        "loadFeatureFileFormat": "SPRO4", "loadFeatureFileExtension": ".prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech", "mixtureDistribCount": K,
        "nbTrainIt": 3, "baggedFrameProbability": 1.0,
        "initVarianceFlooring": 0.5, "finalVarianceFlooring": 0.1,
        "inputWorldFilename": "wld", "totalVariabilityMatrix": "TV",
        "meanEstimate": "TVmean", "fastStats": fast_stats,
        "torchDevice": "cpu"})
    cfg.update(extra)
    return cfg


def _run_chain(pkg, d, t0, work, fast_stats, monkeypatch):
    """TrainWorld → TotalVariability → IvExtractor → IvTest through one
    package's tools; returns the IvTest results."""
    os.makedirs(work)
    shutil.copy(os.path.join(d, "init.gmm"), os.path.join(work, "init.gmm"))
    if pkg == "jax":
        cls = JConfig
        tools = (j_train_world, j_total_variability, j_iv_extractor,
                 j_iv_test)
        monkeypatch.setattr(j_total_variability, "init_t",
                            lambda key, rank, gmm, scale=1.0:
                            jtv.TvModel.from_ubm(t0, gmm))
        if fast_stats:
            monkeypatch.setattr(
                jem, "default_stats_fn",
                lambda fast_math=False, fast_stats=False, **kw:
                lambda x, w, g: jem_fused(x, w, g, block=512, interpret=True,
                                          mxu_precision="highest",
                                          stats_pass="bf16nx"))
            monkeypatch.setattr(
                jstats, "bw_stats_batch",
                lambda x, m, g, stats_pass="x3", **kw: jstats.BwStats(
                    *jbw_fused(x, m, g, interpret=True,
                               mxu_precision="highest",
                               stats_pass=stats_pass)[:2]))
    else:
        cls = TConfig
        tools = (t_train_world, t_total_variability, t_iv_extractor,
                 t_iv_test)
        monkeypatch.setattr(t_total_variability, "init_t",
                            lambda gen, rank, gmm, scale=1.0:
                            ttv.TvModel.from_ubm(torch.from_numpy(t0), gmm))
    train_world, total_variability, iv_extractor, iv_test = tools
    train_world.main(_config(cls, d, work, fast_stats,
                             inputFeatureFilename="bg.lst",
                             inputWorldFilename="init",
                             outputWorldFilename="wld"))
    total_variability.main(_config(cls, d, work, fast_stats,
                                   ndxFilename=os.path.join(d, "tv.ndx"),
                                   totalVariabilityNumber=RANK, nbIt=2))
    iv_extractor.main(_config(cls, d, work, fast_stats,
                              ndxFilename=os.path.join(d, "all.ndx"),
                              ivectorsOutput=os.path.join(work, "iv.npz")))
    return iv_test.main(_config(
        cls, d, work, fast_stats, scoring="cosine",
        targetIdList=os.path.join(d, "targets.ndx"),
        ndxFilename=os.path.join(d, "trials.ndx"),
        outputFilename=os.path.join(work, "scores.nist")))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.max(np.abs(want)))
    print(f"max|got-want| {np.max(np.abs(got - want)):.3e} of {scale:.3e}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("fast_stats", [False, True],
                         ids=["default", "fastStats"])
def test_cli_chain_matches_jax(corpus, tmp_path, monkeypatch, fast_stats):
    d, t0 = corpus
    # both sides run f32 arithmetic on the CPU: JAX's CPU dots are f32
    # whatever jax_default_matmul_precision says, the port's tensors are
    # float32 CPU tensors with TF32 off
    assert jax.default_backend() == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    before = dict(launch_counts)
    res = {pkg: _run_chain(pkg, d, t0, str(tmp_path / pkg), fast_stats,
                           monkeypatch) for pkg in ("jax", "torch")}
    assert launch_counts == before          # CPU tensors: plain versions
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")

    ubm_tol, t_tol = (5e-3, 2e-3) if fast_stats else (1e-4, 1e-3)
    for a, b in zip(read_gmm_file(os.path.join(tdir, "wld.gmm")),
                    read_gmm_file(os.path.join(jdir, "wld.gmm"))):
        _close(a, b, ubm_tol)
    for name in ("TV.matx", "TVmean.matx"):
        _close(read_matrix_file(os.path.join(tdir, name)),
               read_matrix_file(os.path.join(jdir, name)), t_tol)
    wt = np.load(os.path.join(tdir, "iv.npz"), allow_pickle=True)
    wj = np.load(os.path.join(jdir, "iv.npz"), allow_pickle=True)
    assert list(wt["names"]) == list(wj["names"])
    assert wt["w"].shape == (N_SPK * (SESS + 2), RANK)
    _close(wt["w"], wj["w"], 1e-3)
    st = read_nist_scores(os.path.join(tdir, "scores.nist"))
    sj = read_nist_scores(os.path.join(jdir, "scores.nist"))
    assert len(st) == len(sj) == N_SPK * N_SPK
    assert [(a.model, a.seg) for a in st] == [(b.model, b.seg) for b in sj]
    _close(np.array([a.score for a in st]), np.array([b.score for b in sj]),
           1e-3)
    # the NIST file keeps 6 decimals of what IvTest returned
    np.testing.assert_allclose([r.score for r in res["torch"]],
                               [a.score for a in st], rtol=0, atol=1e-6)


def test_tv_compute_llk_matches_jax(corpus, tmp_path, monkeypatch, capsys):
    """TotalVariability's ``computeLLK`` check, per EM iteration, in both
    packages from the same UBM and T: the printed totals (sums of 3 mean
    frame llks over sessions of unequal length) within rel 1e-5."""
    d, t0 = corpus
    monkeypatch.setattr(j_total_variability, "init_t",
                        lambda key, rank, gmm, scale=1.0:
                        jtv.TvModel.from_ubm(t0, gmm))
    monkeypatch.setattr(t_total_variability, "init_t",
                        lambda gen, rank, gmm, scale=1.0:
                        ttv.TvModel.from_ubm(torch.from_numpy(t0), gmm))
    totals = {}
    for pkg, cls, tool in (("jax", JConfig, j_total_variability),
                           ("torch", TConfig, t_total_variability)):
        work = str(tmp_path / pkg)
        os.makedirs(work)
        shutil.copy(os.path.join(d, "init.gmm"), os.path.join(work,
                                                              "init.gmm"))
        capsys.readouterr()
        tool.main(_config(cls, d, work, False, inputWorldFilename="init",
                          ndxFilename=os.path.join(d, "tv.ndx"),
                          totalVariabilityNumber=RANK, nbIt=2,
                          computeLLK=3))
        totals[pkg] = [float(line.split("Total LLK=")[1].split()[0])
                       for line in capsys.readouterr().out.splitlines()
                       if "Total LLK=" in line]
    assert len(totals["torch"]) == 2
    np.testing.assert_allclose(totals["torch"], totals["jax"], rtol=1e-5)


# -- tools plumbing -----------------------------------------------------------

def test_resolve_device_never_falls_back():
    assert tcommon.resolve_device(TConfig({"torchDevice": "cpu"})).type \
        == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cfg in (TConfig(), TConfig({"torchDevice": "cuda"})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcommon.resolve_device(cfg)


def test_stats_fn_and_lists_match_jax(corpus):
    from lia_ral_tpu.tools import common as jcommon

    d, _ = corpus
    base = {"lstPath": d + "/", "featureFilesPath": d + "/",
            "labelFilesPath": d + "/", "loadFeatureFileFormat": "SPRO4"}
    tc, jc = TConfig(base), JConfig(base)
    for key, val in (("inputFeatureFilename", "bg.lst"),
                     ("inputFeatureFilename", "dev_s0_0")):
        tc[key] = jc[key] = val
        assert tcommon.resolve_list(tc, key) == jcommon.resolve_list(jc, key)
    assert tcommon.resolve_stats_fn(tc) is None
    names = ["dev_s0_0", "test_s1", "missing"]
    got = tcommon.load_files_batch(names, tc)
    want = jcommon.load_files_batch(names, jc)
    assert got[2] is None and want[2] is None
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    for name, x in zip(names, got[:2]):
        np.testing.assert_array_equal(
            tcommon.file_frame_mask(name, x.shape[0], tc),
            jcommon.file_frame_mask(name, x.shape[0], jc))
    fs_t, m_t = tcommon.load_features_and_mask(names[:2], tc)
    fs_j, m_j = jcommon.load_features_and_mask(names[:2], jc)
    np.testing.assert_array_equal(fs_t.data, fs_j.data)
    np.testing.assert_array_equal(m_t, m_j)
    tc["featureServerBufferSize"] = jc["featureServerBufferSize"] = "300"
    assert tcommon.feature_buffer_size(tc) == 300
    for (xt, wt), (xj, wj) in zip(
            tcommon.feature_chunk_loader(names[:2], tc, 300)(),
            jcommon.feature_chunk_loader(names[:2], jc, 300)()):
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(wt, wj)
    assert tcommon.mixture_path("wld", tc) == jcommon.mixture_path("wld", jc)


@pytest.mark.parametrize("extra", [
    {"approximationMode": "ubmWeight"},
    {"ivExtractionMode": "eigenDecomposition"},
    {"scoring": "plda"}, {"ivNorm": "true"}, {"wccn": "true"},
], ids=["tv_approximation", "iv_eigen", "iv_test_plda", "iv_test_ivnorm",
        "iv_test_wccn"])
def test_unported_modes_raise(extra):
    tool = {"approximationMode": t_total_variability,
            "ivExtractionMode": t_iv_extractor}.get(next(iter(extra)),
                                                     t_iv_test)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        tool.main(TConfig(dict(extra, torchDevice="cpu")))


def test_main_dispatch(tmp_path, capsys):
    assert tmain.main([]) == 0
    assert "TrainWorld" in capsys.readouterr().out
    assert tmain.main(["PLDA"]) == 2
    assert "not ported" in capsys.readouterr().err
    assert tmain.main(["NoSuchTool"]) == 2
    # a ported tool through the CLI entry, with binary score output
    work = str(tmp_path)
    from lia_ral_tpu_torch.io.matrix import write_matrix_file
    rng = np.random.default_rng(0)
    for name in ["enroll_s0", "enroll_s1", "test_s0", "test_s1"]:
        write_matrix_file(os.path.join(work, name + ".y"),
                          rng.standard_normal((1, RANK)))
    write_xlist(os.path.join(work, "t.ndx"),
                [["model0", "enroll_s0"], ["model1", "enroll_s1"]])
    write_xlist(os.path.join(work, "trials.ndx"),
                [["test_s0", "model0", "model1"], ["test_s1", "model1"]])
    out = os.path.join(work, "sc")
    assert tmain.main(["IvTest", "--torchDevice", "cpu",
                       "--loadVectorFilesPath", work + "/",
                       "--targetIdList", os.path.join(work, "t.ndx"),
                       "--ndxFilename", os.path.join(work, "trials.ndx"),
                       "--outputScoreFormat", "binary",
                       "--outputFilename", out]) == 0
    mat = read_matrix_file(out + ".matx")
    assert mat.shape == (2, 2)
    assert open(out + "_model.txt").read().split() == ["model0", "model1"]
    assert open(out + "_testSeg.txt").read().split() == ["test_s0",
                                                         "test_s1"]
    jres = j_iv_test.main(JConfig({
        "loadVectorFilesPath": work + "/",
        "targetIdList": os.path.join(work, "t.ndx"),
        "ndxFilename": os.path.join(work, "trials.ndx"),
        "outputFilename": os.path.join(work, "jsc.nist")}))
    want = {(r.model, r.seg): r.score for r in jres}
    np.testing.assert_allclose(mat[0, 0], want[("model0", "test_s0")],
                               rtol=1e-6)
    np.testing.assert_allclose(mat[1, 1], want[("model1", "test_s1")],
                               rtol=1e-6)
