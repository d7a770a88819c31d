"""The port's CLI chains against the JAX package's, plus the tools'
plumbing: TrainWorld → TotalVariability → IvExtractor → IvTest (cosine);
the i-vector back end on top of it (approximation modes, IvNorm, PLDA,
every IvTest scoring); the GMM-UBM chain; the JFA/LFA chain.

Both packages' ``tools.*.main`` run in their own temp directory on the
same feature and label files (a tests/test_tools_iv.py-sized corpus:
K=16, D=8, R=4, 12 speakers).  Neither side draws random numbers:
TrainWorld starts from one shared ``inputWorldFilename`` with
``baggedFrameProbability=1``, and TotalVariability's ``init_t`` is
patched here, on both sides, to return the same T.

The JAX package's stats paths on the CPU ignore ``fastStats`` (they run
XLA whatever the key says), so for the fastStats chain the JAX side's
stats are routed through its Pallas kernels in interpret mode with
``stats_pass="bf16nx"``, as the JAX suite's own tests run them, with
their default three-pass bf16 logit product (``mxu_precision="bf16x3"``),
which the port's kernel and plain version compute too.

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
from tests.conftest import REFERENCE, requires_reference

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
    # the back-end and JFA chains' lists: the dev sessions by speaker, and
    # models that enrol two sessions
    write_xlist(os.path.join(d, "dev.ndx"),
                [[f"spk{s}"] + [f"dev_s{s}_{j}" for j in range(SESS)]
                 for s in range(N_SPK)])
    write_xlist(os.path.join(d, "targets2.ndx"),
                [[m, f, f"dev_s{s}_0"] for s, (m, f) in enumerate(enroll)])
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
                                          stats_pass="bf16nx"))
            monkeypatch.setattr(
                jstats, "bw_stats_batch",
                lambda x, m, g, stats_pass="x3", **kw: jstats.BwStats(
                    *jbw_fused(x, m, g, interpret=True,
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


# -- the i-vector back end (configs 3 and 5) ------------------------------------
#
# On the chain above (default tier): TotalVariability with each
# approximationMode → IvExtractor exact, ubmWeight, eigenDecomposition →
# IvNorm (EFR, 2 iterations, + LDA) → PLDA (warm-started from matrix files
# both packages read: ``pldaLoadInitMatrices``, since the random streams
# differ) → IvTest in every scoring.  36 dev vectors of rank 4 (N = 9·R).
#
# Tolerances: scores 1e-3 of the score list's scale (the chain's
# i-vector budget; measured 3e-5 after whitening, an f32 inverse or five
# PLDA EM iterations); PLDA trained inside IvTest from each package's own random
# init: compared by EER and by each segment's best model only.  Files that hold
# eigenvectors are compared through invariants (_torch_parity.py), never
# element by element.

BACKEND_TOL = 1e-3
IVTEST_MODES = {
    "cos_wccn": dict(scoring="cosine", ivNorm="true", ivNormIterationNb=2,
                     wccn="true", wccnMatrix="wccn"),
    "cos_wccn_loaded": dict(scoring="cosine", ivNorm="true",
                            ivNormIterationNb=2, ivNormLoadParam="true",
                            wccn="true", loadWccnMatrix="true",
                            wccnMatrix="wccn"),
    "maha": dict(scoring="mahalanobis", ivNorm="true",
                 mahalanobisMatrix="maha"),
    "maha_loaded": dict(scoring="mahalanobis", ivNorm="true",
                        ivNormLoadParam="true", loadMahalanobisMatrix="true",
                        mahalanobisMatrix="maha"),
    "2cov": dict(scoring="2cov", ivNorm="true"),
    "2cov_loaded": dict(scoring="2cov", ivNorm="true", ivNormLoadParam="true",
                        load2covMatrix="true"),
    "lda": dict(scoring="cosine", ivNorm="true", ldaRank=3,
                ldaMatrix="ldaFromIvTest"),
    "loadparam_lda_binary": dict(scoring="cosine", ivNorm="true",
                                 ivNormIterationNb=2, ivNormLoadParam="true",
                                 LDA="true", ldaMatrix="ldaFromIvNorm",
                                 outputScoreFormat="binary"),
    "plda": dict(scoring="plda", vectors="normed", targets="targets2.ndx",
                 pldaModelFilename="plda.npz"),
    "pldaMean": dict(scoring="pldaMean", vectors="normed",
                     targets="targets2.ndx", pldaModelFilename="plda.npz"),
    "plda_trained": dict(scoring="plda", ivNorm="true", randomSeed=3,
                         pldaEigenVoiceNumber=3, pldaNbIt=10),
}


def _run_backend_chain(pkg, d, t0, plda_init, work, monkeypatch):
    """The back end through one package's tools, on its own run of the
    default-tier chain in ``work``.  Returns {mode: IvTest results}."""
    _run_chain(pkg, d, t0, work, False, monkeypatch)
    if pkg == "jax":
        from lia_ral_tpu.io.matrix import write_matrix_file
        from lia_ral_tpu.tools import iv_norm, plda_tool
        cls, tv, ivx, ivt = (JConfig, j_total_variability, j_iv_extractor,
                             j_iv_test)
    else:
        from lia_ral_tpu_torch.io.matrix import write_matrix_file
        from lia_ral_tpu_torch.tools import iv_norm, plda_tool
        cls, tv, ivx, ivt = (TConfig, t_total_variability, t_iv_extractor,
                             t_iv_test)
    normed = os.path.join(work, "normed")
    for sub in ("normed", "uw", "ed"):
        os.makedirs(os.path.join(work, sub))

    def cfg(**extra):
        return _config(cls, d, work, False, **extra)

    for mode in ("eigenDecomposition", "ubmWeight"):
        tv.main(cfg(ndxFilename=os.path.join(d, "tv.ndx"),
                    totalVariabilityNumber=RANK, nbIt=2,
                    approximationMode=mode))
    for mode, sub in (("ubmWeight", "uw"), ("eigenDecomposition", "ed")):
        ivx.main(cfg(ndxFilename=os.path.join(d, "all.ndx"),
                     ivExtractionMode=mode,
                     saveVectorFilesPath=os.path.join(work, sub) + "/",
                     ivectorsOutput=os.path.join(work, sub + ".npz")))
    dev_ndx = os.path.join(d, "dev.ndx")
    iv_norm.main(cfg(backgroundNdxFilename=dev_ndx, ivNormIterationNb=2,
                     LDA="true", ldaRank=3, ldaMatrix="ldaFromIvNorm",
                     inputVectorFilename=os.path.join(d, "all.ndx"),
                     saveVectorFilesPath=normed + "/"))
    for name, arr in plda_init.items():
        write_matrix_file(os.path.join(work, name + "Init.matx"), arr)
    plda_tool.main(cfg(
        backgroundNdxFilename=dev_ndx, loadVectorFilesPath=normed + "/",
        pldaEigenVoiceNumber=3, pldaEigenChannelNumber=1, pldaNbIt=5,
        pldaLoadInitMatrices="true", pldaMeanVecInit="meanInit",
        pldaEigenVoiceMatrixInit="FInit", pldaEigenChannelMatrixInit="GInit",
        pldaSigmaMatrixInit="SigmaInit",
        pldaModelFilename=os.path.join(work, "plda.npz")))
    out = {}
    for name, extra in IVTEST_MODES.items():
        extra = dict(extra)
        vec_dir = os.path.join(work, extra.pop("vectors", ""))
        if "pldaModelFilename" in extra:
            extra["pldaModelFilename"] = os.path.join(work, "plda.npz")
        out[name] = ivt.main(cfg(
            backgroundNdxFilename=dev_ndx,
            loadVectorFilesPath=vec_dir.rstrip("/") + "/",
            targetIdList=os.path.join(d, extra.pop("targets", "targets.ndx")),
            ndxFilename=os.path.join(d, "trials.ndx"),
            outputFilename=os.path.join(work, name + ".nist"), **extra))
    return out


def _scores(lines):
    return np.array([r.score for r in lines])


def _eer_of(lines):
    from lia_ral_tpu_torch.backend.eval import eer
    sc = _scores(lines)
    tgt = np.array([r.model[len("model"):] == r.seg[len("test_s"):]
                    for r in lines])
    return eer(sc[tgt], sc[~tgt])


def test_backend_chain_matches_jax(corpus, tmp_path, monkeypatch):
    from _torch_parity import assert_close_scaled, gram, metric, projector

    d, t0 = corpus
    rng = np.random.default_rng(5)
    plda_init = {"mean": np.zeros((RANK, 1)),
                 "F": rng.standard_normal((RANK, 3)) * 0.1,
                 "G": rng.standard_normal((RANK, 1)) * 0.1,
                 "Sigma": np.eye(RANK) * 0.05}
    res = {pkg: _run_backend_chain(pkg, d, t0, plda_init,
                                   str(tmp_path / pkg), monkeypatch)
           for pkg in ("jax", "torch")}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")

    def both(name):
        return (read_matrix_file(os.path.join(tdir, name)),
                read_matrix_file(os.path.join(jdir, name)))

    # TotalVariability's approximation files: W and D element-wise, Q
    # through Q·diag·Qᵀ-free invariants (QᵀQ = I, |QtᵀQj| = I)
    for name in ("TV_weightedCov.matx", "TV_EigDec_D.matx"):
        assert_close_scaled(*both(name), 2e-3, err_msg=name)
    qt, qj = both("TV_EigDec_Q.matx")
    np.testing.assert_allclose(qt.T @ qt, np.eye(RANK), atol=1e-5)
    np.testing.assert_allclose(np.abs(qt.T @ qj), np.eye(RANK), atol=1e-2)
    # the approximate i-vectors, against JAX and (a sanity bound only)
    # against the exact ones of the same package
    exact = np.load(os.path.join(tdir, "iv.npz"), allow_pickle=True)["w"]
    for sub in ("uw", "ed"):
        wt = np.load(os.path.join(tdir, sub + ".npz"), allow_pickle=True)["w"]
        wj = np.load(os.path.join(jdir, sub + ".npz"), allow_pickle=True)["w"]
        assert wt.shape == exact.shape
        _close(wt, wj, 1e-3)
        cos = np.sum(wt * exact, 1) / (np.linalg.norm(wt, axis=1)
                                       * np.linalg.norm(exact, axis=1))
        print(f"{sub}: mean cosine to the exact i-vectors {cos.mean():.4f}")
        assert cos.mean() > 0.8
    # IvNorm: the normalised vectors agree up to an orthogonal map, have
    # unit norm, and the saved transforms agree as MᵀM / projector
    names = [f"dev_s{s}_{j}" for s in range(N_SPK) for j in range(SESS)]
    vt, vj = (np.stack([read_matrix_file(os.path.join(w, "normed", n + ".y"))
                        .ravel() for n in names]) for w in (tdir, jdir))
    np.testing.assert_allclose(np.linalg.norm(vt, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(gram(vt), gram(vj), rtol=0, atol=BACKEND_TOL)
    assert_close_scaled(*both("EFR_ivNormEfrMean_it0.matx"), 1e-3)
    mt, mj = both("EFR_ivNormEfrMatrix_it0.matx")
    assert_close_scaled(metric(mt), metric(mj), BACKEND_TOL)
    assert both("EFR_ivNormEfrMatrix_it1.matx")[0].shape == (RANK, RANK)
    for name in ("ldaFromIvNorm.matx", "ldaFromIvTest.matx"):
        pt, pj = both(name)
        assert pt.shape == (3, RANK)
        np.testing.assert_allclose(projector(pt), projector(pj), rtol=0,
                                   atol=1e-2)
    # matrices IvTest wrote while estimating (unique ones element-wise)
    for name in ("wccn.matx", "maha.matx", "2Cov_W.matx", "2Cov_B.matx"):
        assert_close_scaled(*both(name), 5e-3, err_msg=name)
    # PLDA's model files (from the carried init): F·Fᵀ + G·Gᵀ + Σ loosely
    ft, fj = both("pldaEigenVoiceMatrix.matx")
    gt, gj = both("pldaEigenChannelMatrix.matx")
    st, sj = both("pldaSigmaMatrix.matx")
    assert ft.shape == (RANK, 3) and gt.shape == (RANK, 1)
    assert_close_scaled(ft @ ft.T + gt @ gt.T + st, fj @ fj.T + gj @ gj.T + sj,
                        1e-2)
    assert both("pldaMeanVec.matx")[0].shape == (RANK, 1)
    assert both("pldaMinDivMean.matx")[0].shape == (RANK, 1)

    for name in IVTEST_MODES:
        got, want = res["torch"][name], res["jax"][name]
        assert len(got) == len(want) == N_SPK * N_SPK, name
        # the same lines in the same order
        assert [(a.model, a.seg) for a in got] == \
            [(b.model, b.seg) for b in want], name
        sg, sw = _scores(got), _scores(want)
        assert np.isfinite(sg).all(), name
        if name == "plda_trained":
            # each package drew its own init and EM stops at its own
            # point: the EER agrees within 5 points, and every test
            # segment's best model is the same in both packages
            assert abs(_eer_of(got) - _eer_of(want)) <= 0.05, name
            best = [np.argmax(v.reshape(N_SPK, N_SPK), axis=1)
                    for v in (sg, sw)]
            np.testing.assert_array_equal(best[0], best[1], err_msg=name)
            continue
        print(name, end=": ")
        _close(sg, sw, BACKEND_TOL)
        if name != "loadparam_lda_binary":
            ft_ = read_nist_scores(os.path.join(tdir, name + ".nist"))
            # the NIST file keeps 6 significant digits
            np.testing.assert_allclose(_scores(ft_), sg, rtol=1e-5,
                                       atol=1e-6)
    # a loaded matrix scores as the estimated one did (the files hold the
    # f32 values exactly)
    for est, loaded in (("cos_wccn", "cos_wccn_loaded"),
                        ("maha", "maha_loaded")):
        np.testing.assert_allclose(_scores(res["torch"][loaded]),
                                   _scores(res["torch"][est]), rtol=1e-5,
                                   atol=1e-5)
    # binary output: the (M, S) matrix holds the returned scores
    mat = read_matrix_file(os.path.join(tdir,
                                        "loadparam_lda_binary.nist.matx"))
    assert mat.shape == (N_SPK, N_SPK)
    np.testing.assert_allclose(
        mat.T.ravel(), _scores(res["torch"]["loadparam_lda_binary"]),
        rtol=1e-6)
    # speakers separate in every mode (12 target trials of 144)
    for name in IVTEST_MODES:
        assert _eer_of(res["torch"][name]) < 0.35, name


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
    """No mode of TotalVariability, IvExtractor and IvTest is left
    unported: given its mode key and nothing else, each tool gets as far
    as its first mandatory key (a ConfigError, which no not-ported error
    precedes); an unknown mode is a ValueError."""
    from lia_ral_tpu_torch.config import ConfigError

    tool = {"approximationMode": t_total_variability,
            "ivExtractionMode": t_iv_extractor}.get(next(iter(extra)),
                                                     t_iv_test)
    with pytest.raises(ConfigError, match="missing config parameter"):
        tool.main(TConfig(dict(extra, torchDevice="cpu")))
    with pytest.raises(ValueError, match="unknown ivExtractionMode"):
        t_iv_extractor.main(TConfig({"ivExtractionMode": "fast",
                                     "torchDevice": "cpu"}))


def test_main_dispatch(tmp_path, capsys):
    assert tmain.main([]) == 0
    assert "TrainWorld" in capsys.readouterr().out
    # a utility tool: through the umbrella to its first missing key
    from lia_ral_tpu_torch.config import ConfigError
    with pytest.raises(ConfigError, match="missing config parameter"):
        tmain.main(["Scoring", "--torchDevice", "cpu"])
    assert "not ported" not in capsys.readouterr().out
    assert tmain.main(["NoSuchTool"]) == 2
    import importlib
    from lia_ral_tpu import __main__ as jmain
    for name, mod in (("EnergyDetector", "energy_detector"),
                      ("NormFeat", "norm_feat"),
                      ("TrainTarget", "train_target"),
                      ("ComputeTest", "compute_test"),
                      ("ComputeNorm", "compute_norm"),
                      ("IvNorm", "iv_norm"), ("PLDA", "plda_tool"),
                      ("ComputeJFAStats", "jfa_tools"),
                      ("ComputeTVStats", "jfa_tools"),
                      ("EigenVoice", "jfa_tools"),
                      ("EigenChannel", "jfa_tools"),
                      ("EstimateDMatrix", "jfa_tools"),
                      ("SpkAdapt", "spk_adapt"),
                      ("TurnDetection", "spkseg_tools"),
                      ("Segmentation", "spkseg_tools"),
                      ("ReSegmentation", "spkseg_tools"),
                      ("Scoring", "utils_tools"), ("NAPSV", "utils_tools"),
                      ("CovIntra", "utils_tools"),
                      ("SvmTrain", "utils_tools"),
                      ("SvmPredict", "utils_tools")):
        # the module and the preset mode key of the JAX package's table
        assert tmain.TOOLS[name] == jmain.TOOLS[name]
        assert tmain.TOOLS[name][0] == mod
        assert callable(importlib.import_module(
            f"lia_ral_tpu_torch.tools.{mod}").main)
    assert set(tmain.TOOLS) == set(jmain.TOOLS)
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
    # ComputeNorm through the CLI entry: t-norm of those scores by two
    # impostor models
    from lia_ral_tpu_torch.io.nist import ScoreLine, write_nist_scores
    write_nist_scores(os.path.join(work, "main.nist"),
                      [ScoreLine("M", m, "1", t, want[(m, t)])
                       for (m, t) in want])
    imp = [ScoreLine("M", f"imp{i}", "0", t, 0.1 * i - 0.3 * j)
           for i in range(2) for j, t in enumerate(["test_s0", "test_s1"])]
    write_nist_scores(os.path.join(work, "imp.nist"), imp)
    assert tmain.main(["ComputeNorm", "--torchDevice", "cpu",
                       "--normType", "tnorm",
                       "--testNistFile", os.path.join(work, "main.nist"),
                       "--tnormNistFile", os.path.join(work, "imp.nist"),
                       "--outputFileBaseName",
                       os.path.join(work, "tn.nist")]) == 0
    tn = read_nist_scores(os.path.join(work, "tn.nist"))
    assert len(tn) == len(want)
    for r in tn:
        seg = [x.score for x in imp if x.seg == r.seg]
        np.testing.assert_allclose(
            r.score, (want[(r.model, r.seg)] - np.mean(seg)) / np.std(seg),
            rtol=1e-4)


# -- the GMM-UBM chain (configs 1 and 2) --------------------------------------
#
# EnergyDetector → NormFeat → TrainWorld → TrainTarget → ComputeTest →
# ComputeNorm through both packages' tools, each in its own directory on
# copies of one corpus: 12 speakers (8 targets, 4 cohort) × 3 sessions of
# 400 frames, D=10 features plus a log-energy column that is low on ~20 %
# of frames; speakers differ by per-component offsets.  No side draws
# random numbers (a shared init UBM, baggedFrameProbability 1).
#
# Tolerances: speech labels identical; normalised features atol 1e-5
# (f32 CMVN, as tests/test_torch_gmm_ubm.py); UBM and client models
# rtol 1e-4, atol 1e-4·max (the port's EM budget; MAP adds one f32
# interpolation per iteration); every trial score |Δ| ≤ 1e-4 (LLRs of
# O(1) from means of per-frame llks of O(10), and the score file's
# 6 significant digits); normalised scores |Δ| ≤ 1e-3 + 1e-4·|score|
# (z- and t-norm divide by the std of 4 impostor scores, as small as
# O(0.01), so scores reach O(100) and carry the inputs' error times
# 1/std; measured |Δ| 7.5e-3 on a ZT-norm score of 169); with worldDecime
# 2 and top-5, |Δ| ≤ 1e-2: the world's stale-set frames inherit the
# ill-conditioned residual log(exp(full) − exp(top)) of the JAX formula
# (ROADMAP queue 3; the per-frame budget is in
# tests/test_torch_gmm_ubm.py; measured 2.5e-3).

GU_DIM, GU_K, GU_SPK, GU_TGT, GU_SESS, GU_T = 10, 16, 12, 8, 3, 400
SCORE_ATOL, NORM_ATOL, DECIME_ATOL = 1e-4, 1e-3, 1e-2


@pytest.fixture(scope="module")
def gu_corpus(tmp_path_factory):
    """Raw feature files (D+1 columns, energy last), the lists, and the
    shared init UBM, in one directory that each run copies."""
    d = str(tmp_path_factory.mktemp("torch_gmmubm"))
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((GU_K, GU_DIM)) * 2
    # per-speaker offsets of each component (a constant per-file shift
    # would not survive file CMVN); a per-session shift as the channel
    shift = rng.standard_normal((GU_SPK, GU_K, GU_DIM)) * 0.5
    names = []
    for s in range(GU_SPK):
        for j in range(GU_SESS):
            comp = rng.integers(0, GU_K, GU_T)
            x = (centers[comp] + shift[s, comp]
                 + rng.standard_normal((GU_T, GU_DIM)) * 0.6 + j * 0.3)
            low = np.zeros(GU_T, bool)
            for start in rng.integers(0, GU_T - 20, 4):
                low[start:start + 20] = True
            energy = np.where(low, rng.normal(-3.0, 0.5, GU_T),
                              rng.normal(4.0, 1.0, GU_T))
            name = f"spk{s:02d}_s{j}"
            write_feature_file(os.path.join(d, name + ".prm"),
                               np.c_[x, energy].astype(np.float32),
                               fmt="SPRO4")
            names.append(name)
    spk = [f"spk{s:02d}" for s in range(GU_SPK)]
    tgt, coh = spk[:GU_TGT], spk[GU_TGT:]
    lists = {"all": [[n] for n in names],
             "world": [[f"{s}_s{j}"] for s in spk for j in (0, 1)],
             "models": [[s, f"{s}_s0", f"{s}_s1"] for s in spk],
             "main": [[f"{s}_s2"] + tgt for s in tgt],
             "z": [[f"{s}_s2"] + tgt for s in coh],
             "t": [[f"{s}_s2"] + coh for s in tgt],
             "zt": [[f"{s}_s2"] + coh for s in coh]}
    for key, lines in lists.items():
        write_xlist(os.path.join(d, key + ".ndx"), lines)
    w, m, ci = random_gmm_np(rng, GU_K, GU_DIM)
    JGmm.create(w, centers.astype(np.float32), ci * 0.5).save(
        os.path.join(d, "init.gmm"))
    return d


def _gu_tools(pkg):
    if pkg == "jax":
        from lia_ral_tpu.tools import (compute_norm, compute_test,
                                       energy_detector, norm_feat,
                                       train_target)
        return JConfig, dict(EnergyDetector=energy_detector,
                             NormFeat=norm_feat, TrainWorld=j_train_world,
                             TrainTarget=train_target,
                             ComputeTest=compute_test,
                             ComputeNorm=compute_norm)
    from lia_ral_tpu_torch.tools import (compute_norm, compute_test,
                                         energy_detector, norm_feat,
                                         train_target)
    return TConfig, dict(EnergyDetector=energy_detector, NormFeat=norm_feat,
                         TrainWorld=t_train_world, TrainTarget=train_target,
                         ComputeTest=compute_test, ComputeNorm=compute_norm)


def _gu_config(cls, d, work, **extra):
    cfg = cls({
        "featureFilesPath": work + "/", "labelFilesPath": work + "/",
        "mixtureFilesPath": work + "/", "lstPath": d + "/",
        "loadFeatureFileFormat": "SPRO4", "saveFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".norm.prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "labelSelectedFrames": "speech", "torchDevice": "cpu"})
    cfg.update(extra)
    return cfg


GU_TESTS = {
    "plain": {},
    "segmental": {"segmentalMode": "segmentLLR"},
    "window": {"windowLLR": "true", "windowLLRSize": 50,
               "windowLLRDec": 25},
    "byLabel": {"computeTestMode": "byLabel"},
    "histo": {"computeTestMode": "histo"},
    "histo_mean": {"computeTestMode": "histo", "scoreType": "mean"},
    "decime": {"worldDecime": 2, "topDistribsCount": 5},
}
GU_NORMS = {"ztnorm": {}, "znorm_median": {"normType": "znorm",
                                          "meanMode": "1"},
            "tnorm_trim": {"normType": "tnorm", "percentH": 0.25},
            "tznorm": {"normType": "tznorm"}}


def _run_gmm_ubm_chain(pkg, d, work):
    """The chain through one package's tools; returns the ComputeTest and
    ComputeNorm results by name."""
    cls, tool = _gu_tools(pkg)
    os.makedirs(work)
    for f in os.listdir(d):
        if f.endswith((".prm", ".gmm")):
            shutil.copy(os.path.join(d, f), work)

    def cfg(**extra):
        return _gu_config(cls, d, work, **extra)

    tool["EnergyDetector"].main(cfg(
        inputFeatureFilename="all.ndx", loadFeatureFileExtension=".prm",
        featureServerMask=str(GU_DIM), addDefaultLabel="true",
        defaultLabel="speech", nbTrainIt=10, mixtureDistribCount=3,
        alpha=0.25))
    tool["NormFeat"].main(cfg(
        inputFeatureFilename="all.ndx", loadFeatureFileExtension=".prm",
        featureServerMask=f"0-{GU_DIM - 1}", mode="norm",
        segmentalMode="file", saveFeatureFileExtension=".norm.prm"))
    tool["TrainWorld"].main(cfg(
        inputFeatureFilename="world.ndx", inputWorldFilename="init",
        outputWorldFilename="wld", mixtureDistribCount=GU_K, nbTrainIt=3,
        baggedFrameProbability=1.0, initVarianceFlooring=0.5,
        finalVarianceFlooring=0.1))
    tool["TrainTarget"].main(cfg(
        targetIdList=os.path.join(d, "models.ndx"), inputWorldFilename="wld",
        MAPAlgo="MAPOccDep", meanAdapt="true", MAPRegFactorMean=14.0,
        nbTrainIt=3, baggedFrameProbability=1.0))
    out = {}
    for lst in ("main", "z", "t", "zt"):
        out[lst] = tool["ComputeTest"].main(cfg(
            ndxFilename=os.path.join(d, lst + ".ndx"),
            inputWorldFilename="wld", topDistribsCount=10,
            outputFilename=os.path.join(work, lst + ".nist")))
    for name, extra in GU_TESTS.items():
        if name != "plain":
            out[name] = tool["ComputeTest"].main(cfg(**dict(
                dict(ndxFilename=os.path.join(d, "main.ndx"),
                     inputWorldFilename="wld", topDistribsCount=10,
                     outputFilename=os.path.join(work, name + ".nist")),
                **extra)))
    for name, extra in GU_NORMS.items():
        out[name] = tool["ComputeNorm"].main(cfg(**dict(dict(
            normType="ztnorm",
            testNistFile=os.path.join(work, "main.nist"),
            znormNistFile=os.path.join(work, "z.nist"),
            tnormNistFile=os.path.join(work, "t.nist"),
            ztnormNistFile=os.path.join(work, "zt.nist"),
            outputFileBaseName=os.path.join(work, name + ".nist")), **extra)))
    return out


def _trial_keys(lines):
    return [(r.model, r.seg, r.begin, r.end, r.decision) for r in lines]


def test_gmm_ubm_chain_matches_jax(gu_corpus, tmp_path):
    d = gu_corpus
    before = dict(launch_counts)
    res = {pkg: _run_gmm_ubm_chain(pkg, d, str(tmp_path / pkg))
           for pkg in ("jax", "torch")}
    assert launch_counts == before          # CPU tensors: plain versions
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    names = [f"spk{s:02d}_s{j}" for s in range(GU_SPK)
             for j in range(GU_SESS)]
    from lia_ral_tpu_torch.io.labels import read_label_file
    n_speech = 0
    for n in names:
        lt = read_label_file(os.path.join(tdir, n + ".lbl"))
        assert lt == read_label_file(os.path.join(jdir, n + ".lbl"))
        n_speech += sum(s.end - s.begin for s in lt) / 0.01
        from lia_ral_tpu_torch.io.features import read_feature_file
        a, b = (read_feature_file(os.path.join(w, n + ".norm.prm"),
                                  fmt="SPRO4").data for w in (tdir, jdir))
        assert a.shape == (GU_T, GU_DIM)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    # the energy VAD kept part of the frames (meanStd keeps the frames
    # above the top component's mean − α·σ: ~40 % here)
    assert 0.25 < n_speech / (len(names) * GU_T) < 0.8
    for model in ["wld"] + [f"spk{s:02d}" for s in range(GU_SPK)]:
        for a, b in zip(read_gmm_file(os.path.join(tdir, model + ".gmm")),
                        read_gmm_file(os.path.join(jdir, model + ".gmm"))):
            _close(a, b, 1e-4)
    n_trials = {"main": GU_TGT * GU_TGT, "z": 4 * GU_TGT, "t": GU_TGT * 4,
                "zt": 16}
    for name in list(n_trials) + list(GU_TESTS)[1:] + list(GU_NORMS):
        got, want = res["torch"][name], res["jax"][name]
        assert len(got) == len(want) > 0, name
        if name in n_trials:
            assert len(got) == n_trials[name]
        # the same trial lines in the same order (decision included)
        assert _trial_keys(got) == _trial_keys(want), name
        sg = np.array([r.score for r in got])
        sw = np.array([r.score for r in want])
        assert np.isfinite(sg).all()
        atol = (NORM_ATOL if name in GU_NORMS else
                DECIME_ATOL if name == "decime" else SCORE_ATOL)
        rtol = 1e-4 if name in GU_NORMS else 0.0
        np.testing.assert_allclose(sg, sw, rtol=rtol, atol=atol,
                                   err_msg=name)
        # the NIST files hold the same lines in the same order
        ft = read_nist_scores(os.path.join(tdir, name + ".nist"))
        fj = read_nist_scores(os.path.join(jdir, name + ".nist"))
        assert _trial_keys(ft) == _trial_keys(fj), name
    # targets score above impostors, raw and ZT-normed
    for name in ("main", "ztnorm"):
        sc = res["torch"][name]
        tgt = np.array([r.score for r in sc if r.seg.startswith(r.model)])
        imp = np.array([r.score for r in sc
                        if not r.seg.startswith(r.model)])
        assert tgt.mean() > imp.mean(), name


NORMFEAT_MODES = {
    "file": {"segmentalMode": "file"},
    "file_cms": {"segmentalMode": "file", "cmsOnly": "true"},
    "segment": {"segmentalMode": "segment"},
    "window": {"segmentalMode": "window", "windowDuration": 0.5},
    "featWarp": {"mode": "featWarp", "windowDuration": 1.0},
    "featMap": {"mode": "featMap", "channelMixture": "chan",
                "inputWorldFilename": "root"},
    "speech_only": {"segmentalMode": "file", "writeAllFeatures": "false"},
}


@pytest.mark.parametrize("mode", list(NORMFEAT_MODES))
def test_norm_feat_modes_match_jax(gu_corpus, tmp_path, mode):
    """Every ported NormFeat mode, both packages on the same files (one of
    them shorter than half the warping window) with the same labels:
    outputs within atol 1e-5 (f32 CMVN; the warp ranks are exact), the
    info mode's printed stats to 1e-5 relative."""
    from lia_ral_tpu.tools import norm_feat as jnf
    from lia_ral_tpu_torch.io.features import read_feature_file
    from lia_ral_tpu_torch.tools import norm_feat as tnf

    d = gu_corpus
    rng = np.random.default_rng(23)
    names = ["spk00_s0", "spk01_s1", "short"]
    for name in names[:2]:
        shutil.copy(os.path.join(d, name + ".prm"), str(tmp_path))
    write_feature_file(os.path.join(str(tmp_path), "short.prm"),
                       rng.standard_normal((40, GU_DIM + 1))
                       .astype(np.float32), fmt="SPRO4")
    write_label_file(os.path.join(str(tmp_path), "spk00_s0.lbl"),
                     [Segment(0.2, 1.5, "speech"), Segment(2.0, 3.9, "speech")])
    w, m, ci = random_gmm_np(rng, 4, GU_DIM)
    JGmm.create(w, m, ci).save(os.path.join(str(tmp_path), "chan.gmm"))
    JGmm.create(w, m + 0.5, ci * 2).save(os.path.join(str(tmp_path),
                                                      "root.gmm"))
    write_xlist(os.path.join(str(tmp_path), "files.lst"),
                [[n] for n in names])
    outs = {}
    for pkg, cls, tool in (("jax", JConfig, jnf), ("torch", TConfig, tnf)):
        cfg = cls({
            "featureFilesPath": str(tmp_path) + "/",
            "labelFilesPath": str(tmp_path) + "/",
            "mixtureFilesPath": str(tmp_path) + "/",
            "lstPath": str(tmp_path) + "/",
            "loadFeatureFileFormat": "SPRO4",
            "saveFeatureFileFormat": "SPRO4",
            "saveFeatureFileExtension": f".{pkg}.prm",
            "featureServerMask": f"0-{GU_DIM - 1}",
            "addDefaultLabel": "true", "defaultLabel": "speech",
            "labelSelectedFrames": "speech", "torchDevice": "cpu",
            "inputFeatureFilename": "files.lst", "mode": "norm"})
        cfg.update(NORMFEAT_MODES[mode])
        outs[pkg] = tool.main(cfg)
    for name in names:
        a = read_feature_file(os.path.join(str(tmp_path),
                                           name + ".torch.prm")).data
        b = read_feature_file(os.path.join(str(tmp_path),
                                           name + ".jax.prm")).data
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        np.testing.assert_allclose(outs["torch"][name], a, rtol=0, atol=0)


def test_norm_feat_info_matches_jax(gu_corpus, tmp_path, capsys):
    from lia_ral_tpu.tools import norm_feat as jnf
    from lia_ral_tpu_torch.tools import norm_feat as tnf

    d = gu_corpus
    outs = {}
    for pkg, cls, tool in (("jax", JConfig, jnf), ("torch", TConfig, tnf)):
        outs[pkg] = tool.main(cls({
            "featureFilesPath": d + "/", "labelFilesPath": d + "/",
            "loadFeatureFileFormat": "SPRO4", "addDefaultLabel": "true",
            "defaultLabel": "speech", "labelSelectedFrames": "speech",
            "torchDevice": "cpu", "inputFeatureFilename": "spk02_s1",
            "mode": "info"}))
    np.testing.assert_allclose(outs["torch"]["spk02_s1"],
                               outs["jax"]["spk02_s1"], rtol=1e-5)
    assert capsys.readouterr().out.count("[spk02_s1] mean=") == 2


def _trained_models(gu_corpus, work):
    """The torch package's UBM and client models of the chain in
    ``work`` (NormFeat and TrainWorld/TrainTarget only)."""
    d = gu_corpus
    os.makedirs(work)
    for f in os.listdir(d):
        if f.endswith((".prm", ".gmm")):
            shutil.copy(os.path.join(d, f), work)
    from lia_ral_tpu_torch.tools import norm_feat, train_target
    cfg = lambda **kw: _gu_config(TConfig, d, work, addDefaultLabel="true",
                                  defaultLabel="speech", **kw)
    norm_feat.main(cfg(inputFeatureFilename="all.ndx",
                       loadFeatureFileExtension=".prm",
                       featureServerMask=f"0-{GU_DIM - 1}", mode="norm",
                       saveFeatureFileExtension=".norm.prm"))
    t_train_world.main(cfg(inputFeatureFilename="world.ndx",
                           inputWorldFilename="init",
                           outputWorldFilename="wld",
                           mixtureDistribCount=GU_K, nbTrainIt=2,
                           baggedFrameProbability=1.0))
    train_target.main(cfg(targetIdList=os.path.join(d, "models.ndx"),
                          inputWorldFilename="wld", meanAdapt="true",
                          nbTrainIt=2))
    return cfg


def test_compute_test_keys_match_jax(gu_corpus, tmp_path, capsys):
    """maxTargetLine, nbMaxMixtureInMemory, per-line failure containment
    (a missing test file, a missing model) and skipExistingOutput, in
    both packages on the same models: the same lines, in NDX order,
    scores within 1e-4."""
    from lia_ral_tpu.tools import compute_test as jct
    from lia_ral_tpu_torch.tools import compute_test as tct

    work = str(tmp_path / "w")
    cfg = _trained_models(gu_corpus, work)
    write_xlist(os.path.join(work, "odd.ndx"), [
        ["spk03_s2", "spk00", "spk01", "nosuchmodel", "spk02", "spk03"],
        ["nosuchfile", "spk00"],
        ["spk01_s2", "spk01"],
        ["spk00_s2", "spk03", "spk02", "spk01", "spk00"]])
    res = {}
    for pkg, cls, tool in (("jax", JConfig, jct), ("torch", TConfig, tct)):
        c = cls(dict(cfg().items()))
        c.update({"ndxFilename": os.path.join(work, "odd.ndx"),
                  "inputWorldFilename": "wld", "maxTargetLine": 4,
                  "nbMaxMixtureInMemory": 2,
                  "outputFilename": os.path.join(work, pkg + ".nist")})
        res[pkg] = tool.main(c)
        err = capsys.readouterr().out
        assert "cannot read test segment [nosuchfile]" in err
        assert "cannot load model [nosuchmodel]" in err
        # a rerun with skipExistingOutput reads the file back
        c["skipExistingOutput"] = "true"
        again = tool.main(c)
        assert [r.model for r in again] == [r.model for r in res[pkg]]
        assert "skipping" in capsys.readouterr().out
    assert _trial_keys(res["torch"]) == _trial_keys(res["jax"])
    assert [r.model for r in res["torch"]] == [
        "spk00", "spk01", "spk02", "spk01", "spk03", "spk02", "spk01",
        "spk00"]
    np.testing.assert_allclose([r.score for r in res["torch"]],
                               [r.score for r in res["jax"]], rtol=0,
                               atol=SCORE_ATOL)


def test_train_target_keys_match_jax(gu_corpus, tmp_path, capsys):
    """useIdForSelectedFrame (the client id as the frame label) and the
    missing-data warning with useModelData (the world saved as the
    client), in both packages."""
    from lia_ral_tpu.tools import train_target as jtt
    from lia_ral_tpu_torch.tools import train_target as ttt

    work = str(tmp_path / "w")
    cfg = _trained_models(gu_corpus, work)
    write_label_file(os.path.join(work, "spk05_s0.lbl"),
                     [Segment(0.5, 2.5, "spk05")])
    write_label_file(os.path.join(work, "spk05_s1.lbl"),
                     [Segment(1.0, 3.0, "spk05"), Segment(3.2, 3.9, "x")])
    write_xlist(os.path.join(work, "ids.ndx"),
                [["spk05", "spk05_s0", "spk05_s1"], ["ghost", "nofile"]])
    models = {}
    for pkg, cls, tool in (("jax", JConfig, jtt), ("torch", TConfig, ttt)):
        c = cls(dict(cfg().items()))
        c.update({"targetIdList": os.path.join(work, "ids.ndx"),
                  "inputWorldFilename": "wld", "meanAdapt": "true",
                  "varAdapt": "true", "nbTrainIt": 2,
                  "useIdForSelectedFrame": "true", "useModelData": "true",
                  "addDefaultLabel": "false",
                  "saveMixtureFileExtension": f".{pkg}.gmm"})
        models[pkg] = tool.main(c)
        assert "no data for client [ghost]" in capsys.readouterr().out
    for client in ("spk05", "ghost"):
        for a, b in zip(read_gmm_file(os.path.join(work,
                                                   client + ".torch.gmm")),
                        read_gmm_file(os.path.join(work,
                                                   client + ".jax.gmm"))):
            _close(a, b, 1e-4)
    for a, b in zip(read_gmm_file(os.path.join(work, "ghost.torch.gmm")),
                    read_gmm_file(os.path.join(work, "wld.gmm"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tool,extra,item", [
    ("compute_test", {"computeTestMode": "dotProduct"}, 13),
    ("compute_test", {"computeTestMode": "nap"}, 13),
    ("compute_test", {"computeTestMode": "jfa"}, 10),
    ("compute_test", {"computeTestMode": "lfa"}, 10),
    ("train_target", {"channelCompensation": "JFA"}, 10),
    ("train_target", {"channelCompensation": "LFA"}, 10),
    ("train_target", {"channelCompensation": "true"}, 10),
    ("train_target", {"NAP": "true"}, 13),
    ("train_target", {"outputAdaptParam": "true"}, 13),
    ("norm_feat", {"mode": "featFA"}, 10),
    ("norm_feat", {"mode": "featLFA"}, 10),
    ("norm_feat", {"mode": "featNAP"}, 13),
], ids=lambda v: v if isinstance(v, str) else None)
def test_gmm_ubm_unported_modes_raise(tool, extra, item):
    """No mode is left unported: the channel-compensation modes (ROADMAP
    item 10) and the supervector modes (item 13), given the mode key
    alone, get as far as the tool's first mandatory key (a ConfigError,
    which no not-ported error precedes)."""
    import importlib
    from lia_ral_tpu_torch.config import ConfigError

    mod = importlib.import_module(f"lia_ral_tpu_torch.tools.{tool}")
    cfg = TConfig(dict(extra, torchDevice="cpu"))
    assert item in (10, 13)
    with pytest.raises(ConfigError, match="missing config parameter"):
        mod.main(cfg)


# -- the JFA / LFA chain (config 4) ---------------------------------------------
#
# On the i-vector corpus (K=16, D=8; 12 speakers × 3 dev sessions):
# TrainWorld → ComputeJFAStats → EigenVoice (rank 3) → EigenChannel (rank
# 2, loading V) → EstimateDMatrix, each of the three with ``loadAccs`` and
# 2 iterations → TrainTarget channelCompensation=JFA (models of two
# sessions, with the y/x/z and supervector files) → ComputeTest jfa; then
# the LFA variants TrainTarget LFA, ComputeTest lfa and NormFeat featLFA,
# which in both packages read one U (the JAX chain's EC file).  The random
# streams differ, so ``JfaModel.init`` is patched on both sides to return
# the same V and U.
#
# Tolerances: session stats N_TOL / SUM_TOL scaled to the array; V, U, D
# and everything enrolled from them 2e-3 of scale (fa/jfa's training
# budget); scores |Δ| ≤ 1e-3 (LLRs of O(0.1-1)); compensated features
# atol 1e-4.

JFA_TOL, JFA_SCORE_ATOL = 2e-3, 1e-3
JFA_RV, JFA_RU = 3, 2


def _run_jfa_chain(pkg, d, v0, u0, work, monkeypatch, lfa_u=None):
    """The chain through one package's tools in ``work``; ``lfa_u``: the
    U file the LFA steps read (default: this run's own EC).  Returns the
    ComputeTest results by mode."""
    from lia_ral_tpu_torch.io.matrix import write_matrix_file
    os.makedirs(os.path.join(work, "sv"))
    shutil.copy(os.path.join(d, "init.gmm"), os.path.join(work, "init.gmm"))
    if pkg == "jax":
        from lia_ral_tpu.fa import jfa as fa_jfa
        from lia_ral_tpu.tools import (compute_test, jfa_tools, norm_feat,
                                       train_target)
        cls, train_world = JConfig, j_train_world

        def init(cls_, key, rank_v, rank_u, gmm, scale=0.001):
            return fa_jfa.JfaModel(
                v=jnp.asarray(v0[:rank_v]), u=jnp.asarray(u0[:rank_u]),
                d=jnp.zeros(gmm.means.shape, jnp.float32),
                ubm_means=jnp.asarray(gmm.means, jnp.float32),
                ubm_inv_var=jnp.asarray(gmm.cov_inv, jnp.float32))
    else:
        from lia_ral_tpu_torch.fa import jfa as fa_jfa
        from lia_ral_tpu_torch.tools import (compute_test, jfa_tools,
                                             norm_feat, train_target)
        cls, train_world = TConfig, t_train_world

        def init(cls_, gen, rank_v, rank_u, gmm, scale=0.001):
            return fa_jfa.JfaModel(
                v=torch.from_numpy(v0[:rank_v]),
                u=torch.from_numpy(u0[:rank_u]),
                d=torch.zeros(tuple(gmm.means.shape)),
                ubm_means=gmm.means, ubm_inv_var=gmm.cov_inv)
    monkeypatch.setattr(fa_jfa.JfaModel, "init", classmethod(init))

    def cfg(**extra):
        return _config(cls, d, work, False, **extra)

    train_world.main(cfg(inputFeatureFilename="bg.lst",
                         inputWorldFilename="init",
                         outputWorldFilename="wld"))
    accs = os.path.join(work, "accs.npz")
    jfa_tools.main(cfg(jfaMode="stats", ndxFilename=os.path.join(d, "dev.ndx"),
                       accsFilename=accs))
    mats = dict(eigenVoiceMatrix="EV", eigenChannelMatrix="EC", DMatrix="D")
    jfa_tools.main(cfg(jfaMode="eigenVoice", loadAccs="true",
                       accsFilename=accs, eigenVoiceNumber=JFA_RV,
                       eigenChannelNumber=JFA_RU, nbIt=2,
                       eigenVoiceMatrix="EV"))
    jfa_tools.main(cfg(jfaMode="eigenChannel", loadAccs="true",
                       accsFilename=accs, eigenChannelNumber=JFA_RU, nbIt=2,
                       eigenVoiceMatrix="EV", eigenChannelMatrix="EC"))
    jfa_tools.main(cfg(jfaMode="estimateD", loadAccs="true",
                       accsFilename=accs, nbIt=2, regulationFactor=8.0,
                       **mats))
    # EigenVoice once more with orthonormalizeV, from the same init
    jfa_tools.main(cfg(jfaMode="eigenVoice", loadAccs="true",
                       accsFilename=accs, eigenVoiceNumber=JFA_RV,
                       eigenChannelNumber=JFA_RU, nbIt=1,
                       orthonormalizeV="true", eigenVoiceMatrix="EVortho"))
    # TrainTarget enrols with a non-zero D (EstimateDMatrix's stays zero,
    # see the test below), the same file on both sides
    d_rng = np.random.default_rng(19)
    write_matrix_file(os.path.join(work, "Dc.matx"),
                      np.abs(d_rng.standard_normal((1, K * DIM))) * 0.3)
    train_target.main(cfg(targetIdList=os.path.join(d, "targets2.ndx"),
                          channelCompensation="JFA",
                          saveVectorFilesPath=os.path.join(work, "sv") + "/",
                          saveY="true", saveX="true", saveZ="true",
                          **dict(mats, DMatrix="Dc")))
    trials = os.path.join(d, "trials.ndx")
    out = {"jfa": compute_test.main(cfg(
        computeTestMode="jfa", ndxFilename=trials, eigenVoiceMatrix="EV",
        eigenChannelMatrix="EC", topDistribsCount=5,
        outputFilename=os.path.join(work, "jfa.nist")))}
    # the LFA variants, from the carried U
    shutil.copy(lfa_u or os.path.join(work, "EC.matx"),
                os.path.join(work, "ECc.matx"))
    train_target.main(cfg(targetIdList=os.path.join(d, "targets2.ndx"),
                          channelCompensation="LFA",
                          eigenChannelMatrix="ECc", meanAdapt="true",
                          MAPAlgo="MAPOccDep", MAPRegFactorMean=14.0,
                          nbTrainIt=2, saveMixtureFileExtension=".lfa.gmm"))
    # ComputeTest reads the world with the clients' extension
    shutil.copy(os.path.join(work, "wld.gmm"),
                os.path.join(work, "wld.lfa.gmm"))
    out["lfa"] = compute_test.main(cfg(
        computeTestMode="lfa", ndxFilename=trials, eigenChannelMatrix="ECc",
        loadMixtureFileExtension=".lfa.gmm", inputWorldFilename="wld",
        regulationFactor=12.0, topDistribsCount=5,
        outputFilename=os.path.join(work, "lfa.nist")))
    # NormFeat reads and writes under one featureFilesPath: the work dir
    feat = ["test_s0", "dev_s3_1", "enroll_s7"]
    write_xlist(os.path.join(work, "feat.lst"), [[n] for n in feat])
    for n in feat:
        for ext in (".prm", ".lbl"):
            if os.path.exists(os.path.join(d, n + ext)):
                shutil.copy(os.path.join(d, n + ext), work)
    norm_feat.main(cfg(mode="featLFA", lstPath=work + "/",
                       inputFeatureFilename="feat.lst",
                       eigenChannelMatrix="ECc",
                       saveFeatureFileFormat="SPRO4",
                       saveFeatureFileExtension=f".{pkg}.lfa.prm",
                       featureFilesPath=work + "/"))
    return out


def test_jfa_chain_matches_jax(corpus, tmp_path, monkeypatch):
    from lia_ral_tpu_torch.io.features import read_feature_file
    from _torch_parity import N_TOL, SUM_TOL, assert_close_scaled

    d, _ = corpus
    rng = np.random.default_rng(17)
    v0 = (rng.standard_normal((JFA_RV, K, DIM)) * 0.05).astype(np.float32)
    u0 = (rng.standard_normal((JFA_RU, K, DIM)) * 0.05).astype(np.float32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    before = dict(launch_counts)
    res = {"jax": _run_jfa_chain("jax", d, v0, u0, jdir, monkeypatch)}
    res["torch"] = _run_jfa_chain("torch", d, v0, u0, tdir, monkeypatch,
                                  lfa_u=os.path.join(jdir, "EC.matx"))
    assert launch_counts == before          # CPU tensors: plain versions

    at = np.load(os.path.join(tdir, "accs.npz"), allow_pickle=True)
    aj = np.load(os.path.join(jdir, "accs.npz"), allow_pickle=True)
    assert list(at["names"]) == list(aj["names"])
    assert at["n"].shape == (N_SPK * SESS, K)
    np.testing.assert_allclose(at["n"], aj["n"], rtol=N_TOL["rtol"],
                               atol=N_TOL["atol"] * aj["n"].max())
    np.testing.assert_allclose(at["f"], aj["f"], rtol=SUM_TOL["rtol"],
                               atol=SUM_TOL["atol"] * np.abs(aj["f"]).max())
    np.testing.assert_array_equal(np.load(os.path.join(tdir,
                                                       "accs.npz.spk.npy")),
                                  np.load(os.path.join(jdir,
                                                       "accs.npz.spk.npy")))

    def both(name):
        return (read_matrix_file(os.path.join(tdir, name)),
                read_matrix_file(os.path.join(jdir, name)))

    for name, shape in (("EV.matx", (JFA_RV, K * DIM)),
                        ("EC.matx", (JFA_RU, K * DIM)),
                        ("D.matx", (1, K * DIM)),
                        ("EVortho.matx", (JFA_RV, K * DIM))):
        got, want = both(name)
        assert got.shape == shape, name
        print(name, end=": ")
        _close(got, want, JFA_TOL)
        # training moved the matrix off its init
        if name in ("EV.matx", "EC.matx"):
            init = (v0 if name == "EV.matx" else u0).reshape(shape)
            assert np.abs(got - init).max() > 1e-3, name
    ev = both("EVortho.matx")[0]
    np.testing.assert_allclose(ev @ ev.T, np.eye(JFA_RV), atol=1e-5)
    # EstimateDMatrix starts from D = 0 (JfaModel.init), a fixed point of
    # the D update in both packages (z = D·Σ⁻¹·F̃/(τ + N·D²Σ⁻¹) = 0), so
    # the tool writes zeros; tests/test_torch_jfa.py runs the update from
    # a non-zero D
    assert np.abs(both("D.matx")[0]).max() == 0
    for s in range(N_SPK):
        for a, b in zip(read_gmm_file(os.path.join(tdir, f"model{s}.gmm")),
                        read_gmm_file(os.path.join(jdir, f"model{s}.gmm"))):
            _close(a, b, JFA_TOL)
        for ext in (".vect", ".y", ".x", ".z"):
            got, want = both(os.path.join("sv", f"model{s}{ext}"))
            assert got.shape == want.shape and got.shape[0] == 1
            assert_close_scaled(got, want, JFA_TOL, err_msg=f"model{s}{ext}")
        for a, b in zip(
                read_gmm_file(os.path.join(tdir, f"model{s}.lfa.gmm")),
                read_gmm_file(os.path.join(jdir, f"model{s}.lfa.gmm"))):
            _close(a, b, 1e-4)
    # the enrolled model is the world with shifted means
    wt = read_gmm_file(os.path.join(tdir, "wld.gmm"))
    mt = read_gmm_file(os.path.join(tdir, "model3.gmm"))
    np.testing.assert_array_equal(mt[0], wt[0])
    np.testing.assert_array_equal(mt[2], wt[2])
    assert np.abs(mt[1] - wt[1]).max() > 1e-3
    for mode in ("jfa", "lfa"):
        got, want = res["torch"][mode], res["jax"][mode]
        assert len(got) == len(want) == N_SPK * N_SPK
        assert _trial_keys(got) == _trial_keys(want), mode
        sg, sw = _scores(got), _scores(want)
        assert np.isfinite(sg).all()
        print(mode, f"max|Δ| {np.abs(sg - sw).max():.3e} of "
              f"{np.abs(sw).max():.3e}")
        np.testing.assert_allclose(sg, sw, rtol=0, atol=JFA_SCORE_ATOL,
                                   err_msg=mode)
        ft = read_nist_scores(os.path.join(tdir, mode + ".nist"))
        assert _trial_keys(ft) == _trial_keys(got)
        assert _eer_of(got) < 0.35, mode
    for n in ("test_s0", "dev_s3_1", "enroll_s7"):
        a = read_feature_file(os.path.join(tdir, n + ".torch.lfa.prm")).data
        b = read_feature_file(os.path.join(jdir, n + ".jax.lfa.prm")).data
        raw = read_feature_file(os.path.join(d, n + ".prm")).data
        assert a.shape == raw.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        assert np.abs(a - raw).max() > 1e-3         # something was removed


def test_jfa_tools_through_cli_and_skipped_sessions(corpus, tmp_path, capsys):
    """ComputeJFAStats and EigenVoice by their CLI names (the preset
    ``jfaMode``), with an unreadable session in the list: it is skipped
    with a warning, the others keep their order; ``fastStats`` takes the
    bf16 stats tier (its plain version here) and moves F by less than
    its 2e-3 budget."""
    d, _ = corpus
    work = str(tmp_path)
    shutil.copy(os.path.join(d, "init.gmm"), os.path.join(work, "init.gmm"))
    write_xlist(os.path.join(work, "s.ndx"),
                [["spkA", "dev_s0_0", "nosuchfile", "dev_s0_1"],
                 ["spkB", "dev_s1_0"], ["spkA", "dev_s0_2"]])
    common = ["--torchDevice", "cpu", "--featureFilesPath", d + "/",
              "--labelFilesPath", d + "/", "--mixtureFilesPath", work + "/",
              "--matrixFilesPath", work + "/",
              "--loadFeatureFileFormat", "SPRO4",
              "--inputWorldFilename", "init",
              "--ndxFilename", os.path.join(work, "s.ndx")]
    stats = {}
    for tier in ("false", "true"):
        accs = os.path.join(work, f"accs_{tier}.npz")
        assert tmain.main(["ComputeJFAStats", "--accsFilename", accs,
                           "--fastStats", tier, "--verbose", "true"]
                          + common) == 0
        out = capsys.readouterr().out
        assert "cannot read session [nosuchfile]" in out
        assert "stats [spkA/dev_s0_2]" in out
        stats[tier] = np.load(accs, allow_pickle=True)
        assert list(stats[tier]["names"]) == ["dev_s0_0", "dev_s0_1",
                                              "dev_s1_0", "dev_s0_2"]
        np.testing.assert_array_equal(np.load(accs + ".spk.npy"),
                                      [0, 0, 1, 0])
    df = np.abs(stats["true"]["f"] - stats["false"]["f"]).max()
    assert 0 < df <= 2e-3 * np.abs(stats["false"]["f"]).max()
    assert tmain.main(["EigenVoice", "--loadAccs", "true", "--accsFilename",
                       os.path.join(work, "accs_false.npz"),
                       "--eigenVoiceNumber", "2", "--nbIt", "1",
                       "--eigenVoiceMatrix", "EV"] + common) == 0
    ev = read_matrix_file(os.path.join(work, "EV.matx"))
    assert ev.shape == (2, K * DIM) and np.isfinite(ev).all()
    # ComputeTVStats is the same tool under its other name
    assert tmain.main(["ComputeTVStats", "--accsFilename",
                       os.path.join(work, "tv_accs.npz")] + common) == 0
    np.testing.assert_array_equal(
        np.load(os.path.join(work, "tv_accs.npz"), allow_pickle=True)["n"],
        stats["false"]["n"])


# -- the reference's own fixtures -------------------------------------------

@requires_reference
def test_compute_test_golden_llrs(tmp_path):
    """The port's ComputeTest on the reference's ComputeTest.cfg and its
    repaired fixture models against test1.validate.res, at the JAX test's
    bounds (tests/test_parity_golden.py:56-104): the self-consistency
    trials (test2 ≡ wld) within 5e-5, the real trials within 0.03 (the
    fixtures' unrecoverable byte flips)."""
    from lia_ral_tpu.io.gmm_io import _read_gmm_raw, write_gmm_file
    from lia_ral_tpu.io.repair import repair_gmm_raw
    from lia_ral_tpu_torch.tools import compute_test as tct

    ct = os.path.join(REFERENCE, "LIA_SpkDet/ComputeTest/test")
    d = str(tmp_path)
    for name in ("wld", "test1", "test2"):
        with open(os.path.join(ct, name), "rb") as f:
            w, m, ci = _read_gmm_raw(repair_gmm_raw(f.read()))
        write_gmm_file(os.path.join(d, name), w, m, ci, fmt="RAW")
    for t in ("test3", "test4"):
        shutil.copy(os.path.join(ct, "test1.prm"), os.path.join(d, t + ".prm"))
        shutil.copy(os.path.join(ct, "test1.lbl"), os.path.join(d, t + ".lbl"))
    cfg = TConfig.load(os.path.join(ct, "ComputeTest.cfg"))
    cfg["featureFilesPath"] = d + "/"
    cfg["mixtureFilesPath"] = d + "/"
    cfg["labelFilesPath"] = d + "/"
    cfg["loadLabelFileExtension"] = ".lbl"
    cfg["ndxFilename"] = os.path.join(ct, "ndx")
    cfg["outputFilename"] = os.path.join(d, "test1.res")
    cfg["torchDevice"] = "cpu"
    tct.main(cfg)
    golden = read_nist_scores(os.path.join(ct, "test1.validate.res"))
    got = read_nist_scores(os.path.join(d, "test1.res"))
    assert len(golden) == 8 and len(got) == 8
    by_key = {(r.model, r.seg, r.begin, r.end): r.score for r in got}
    for g in golden:
        key = (g.model, g.seg, g.begin, g.end)
        assert key in by_key, f"missing trial {key}"
        delta = abs(by_key[key] - g.score)
        assert delta < (5e-5 if g.model == "test2" else 0.03), \
            (key, by_key[key], g.score)


@requires_reference
def test_energy_detector_on_reference_fixture(tmp_path):
    """The port's EnergyDetector with the reference's config on its
    fixture features (tests/test_tools.py:22-45): speech segments that
    overlap the golden 0.21-0.26 segment, and the JAX tool's labels."""
    from lia_ral_tpu.io.labels import read_label_file
    from lia_ral_tpu.tools import energy_detector as jed
    from lia_ral_tpu_torch.tools import energy_detector as ted

    fix = os.path.join(REFERENCE, "LIA_SpkDet/EnergyDetector/test")
    labels = {}
    for pkg, cls, tool in (("jax", JConfig, jed), ("torch", TConfig, ted)):
        d = str(tmp_path / pkg)
        os.makedirs(d)
        shutil.copy(os.path.join(fix, "test1.prm"), d)
        shutil.copy(os.path.join(fix, "test1.lbl"), d)
        cfg = cls.load(os.path.join(fix, "EnergyDetector.cfg"))
        for k in ("featureFilesPath", "mixtureFilesPath", "labelFilesPath",
                  "lstPath"):
            cfg[k] = d + "/"
        cfg["loadLabelFileExtension"] = ".lbl"
        cfg["torchDevice"] = "cpu"
        tool.main(cfg)
        labels[pkg] = read_label_file(os.path.join(d, "test1.enr.lbl"))
    got = labels["torch"]
    assert got == labels["jax"]
    golden = read_label_file(os.path.join(fix, "test1.validate.enr.lbl"))
    assert len(got) >= 1 and all(g.label == "speech" for g in got)
    v0 = golden[0]
    assert max(min(g.end, v0.end) - max(g.begin, v0.begin) for g in got) > 0
