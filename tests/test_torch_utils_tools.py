"""The twenty LIA_Utils tools through ``python -m lia_ral_tpu_torch <Tool>
--torchDevice cpu`` against ``lia_ral_tpu.tools.utils_tools.main`` on the
same files, ``.svm.npz`` models across the two packages, and the
supervector modes of TrainTarget, ComputeTest and NormFeat with the
GMM-supervector SVM chain (TrainTarget outputAdaptParam → CovIntra →
NAPSV → SvmTrain → SvmPredict) against the JAX tools.

Each package runs in its own copy of one small corpus (a K=16, D=6 world
and clients, six feature files with labels, score files, 40-dimensional
session vectors of 6 speakers, a 30-vector SVM background, symbol
streams, n-gram and label files); the JAX side's SVM models are the ones
SvmPredict scores in both packages.

Tolerances: text outputs equal (scores, labels, symbols, n-grams, the
decoder tree, printed features and models, confusion counts); numeric
files within 1e-6 of their scale (supervectors, NAP projections, f32
products on the host or the CPU); CovIntra's matrix through its
projector (1e-5); PolyExp's printed ``%g`` values within 2e-5 relative
(one unit in the sixth digit); SVM models: the same support vectors, α·y
within 1e-4·C and the bias within 1e-4 (the FISTA budget of
tests/test_torch_utils.py); SVM, dotProduct and NAP score files within
1e-4 of their scale; NormFeat featNAP features within 2e-4 (the JAX
test's budget against its own formula).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from lia_ral_tpu.config import Config as JConfig
from lia_ral_tpu.gmm.model import GmmDiag as JGmm
from lia_ral_tpu.tools import utils_tools as jut

from lia_ral_tpu_torch import __main__ as tmain
from lia_ral_tpu_torch.backend import svm as tsvm
from lia_ral_tpu_torch.config import Config as TConfig
from lia_ral_tpu_torch.gmm.cuda_kernels import launch_counts
from lia_ral_tpu_torch.io.features import read_feature_file, write_feature_file
from lia_ral_tpu_torch.io.gmm_io import read_gmm_file
from lia_ral_tpu_torch.io.labels import Segment, write_label_file
from lia_ral_tpu_torch.io.lists import write_xlist
from lia_ral_tpu_torch.io.matrix import read_matrix_file, write_matrix_file
from lia_ral_tpu_torch.io.nist import ScoreLine, read_nist_scores, \
    write_nist_scores
from lia_ral_tpu_torch.utils import ngram_counts

from _torch_parity import projector, random_gmm_np
from test_torch_tools import GU_SPK, GU_TGT, _gu_config, _trained_models, \
    gu_corpus  # noqa: F401  (the GMM-UBM tools' corpus fixture)

UK, UD, VDIM, N_SPK, SESS, N_BG = 16, 6, 40, 6, 4, 30


@pytest.fixture(scope="module")
def ut_corpus(tmp_path_factory):
    """The read-only inputs of every utility tool, in one directory."""
    d = str(tmp_path_factory.mktemp("torch_utils_tools"))
    rng = np.random.default_rng(31)
    w, m, ci = random_gmm_np(rng, UK, UD)
    m = m * 2.0
    JGmm.create(w, m, ci).save(os.path.join(d, "wld.gmm"))
    for i in range(3):
        JGmm.create(w, m + 0.3 * rng.standard_normal(m.shape), ci).save(
            os.path.join(d, f"c{i}.gmm"))
    for i in range(6):
        comp = rng.choice(UK, 200, p=w)
        x = m[comp] + rng.standard_normal((200, UD)) / np.sqrt(ci[comp])
        write_feature_file(os.path.join(d, f"f{i}.prm"),
                           x.astype(np.float32), fmt="SPRO4")
    write_label_file(os.path.join(d, "f0.lbl"),
                     [Segment(0.1, 0.9, "speech"), Segment(1.2, 1.8, "speech")])
    for name, seed in (("scores", 0), ("scores2", 1)):
        r = np.random.default_rng(seed)
        write_nist_scores(os.path.join(d, name + ".nist"), [
            ScoreLine("M", f"m{i % 4}", "-", f"seg{i // 4}",
                      float(r.standard_normal() + (i % 4 == (i // 4) % 4)))
            for i in range(40)])
    with open(os.path.join(d, "weights.txt"), "w") as f:
        f.write("0.3 0.7\n")
    # session vectors: speaker means, two channel directions, noise
    chan = np.linalg.qr(rng.standard_normal((VDIM, 2)))[0].T
    spk_mean = rng.standard_normal((N_SPK, VDIM)) * 2
    for s in range(N_SPK):
        for j in range(SESS):
            v = (spk_mean[s] + rng.standard_normal(2) * [3.0, 2.0] @ chan
                 + rng.standard_normal(VDIM) * 0.1)
            write_matrix_file(os.path.join(d, f"s{s}_{j}.vect"), v[None, :])
    write_xlist(os.path.join(d, "spk.ndx"),
                [[f"s{s}_{j}" for j in range(SESS)] for s in range(N_SPK)])
    write_xlist(os.path.join(d, "vec.lst"),
                [[f"s{s}_{j}"] for s in range(N_SPK) for j in range(SESS)])
    write_matrix_file(os.path.join(d, "U.mat"), chan)
    for i in range(N_BG):
        write_matrix_file(os.path.join(d, f"bg{i}.vect"),
                          (rng.standard_normal(VDIM) * 2)[None, :])
    write_xlist(os.path.join(d, "bg.lst"), [[f"bg{i}"] for i in range(N_BG)])
    write_xlist(os.path.join(d, "targets.ndx"),
                [[f"t{s}", f"s{s}_0", f"s{s}_1"] for s in range(3)])
    write_xlist(os.path.join(d, "trials.ndx"),
                [[f"s{s}_{j}", "t0", "t1", "t2"]
                 for s in range(N_SPK) for j in (2, 3)])
    # symbol streams, n-gram files and a codebook
    stream = [str(s) for s in rng.integers(0, 5, 400)]
    with open(os.path.join(d, "u1.sym"), "w") as f:
        f.write(" ".join(stream) + "\n")
    for order in (1, 2, 3):
        with open(os.path.join(d, f"ngram{order}.dta"), "w") as f:
            for gram, c in sorted(ngram_counts(stream, order).items()):
                f.write(" ".join(gram) + f" {c}\n")
    with open(os.path.join(d, "cb.3gram"), "w") as f:
        for gram, c in ngram_counts(stream, 3).most_common(10):
            f.write(" ".join(gram) + f" {c}\n")
    for name, hi in (("a0", 3), ("a1", 3), ("b0", 6), ("t0", 3), ("t1", 6)):
        with open(os.path.join(d, name + ".sym"), "w") as f:
            f.write(" ".join(str(s) for s in rng.integers(0, hi, 150)) + "\n")
    with open(os.path.join(d, "R.norm"), "w") as f:     # a PolyExp R file
        for r in rng.random(84) + 0.5:                   # 84 = (6+3)(6+2)(6+1)/6
            f.write(f"{r:g} 0\n")
    write_label_file(os.path.join(d, "l0.lbl"),
                     [Segment(0.0, 0.5, "speech"), Segment(0.9, 1.6, "speech"),
                      Segment(1.7, 1.75, "speech")])
    write_label_file(os.path.join(d, "l1.lbl"),
                     [Segment(0.45, 1.0, "speech"), Segment(1.8, 2.5, "music")])
    # the JAX package's SVM models, scored by SvmPredict in both packages
    jut.main(JConfig({"utilMode": "svmTrain", "vectorFilesPath": d + "/",
                      "backgroundList": os.path.join(d, "bg.lst"),
                      "targetIdList": os.path.join(d, "targets.ndx")}))
    return d


def _workdir(base, tmp_path, pkg):
    """A package's own copy of the corpus, with the lists that hold paths
    written for it."""
    w = str(tmp_path / pkg)
    shutil.copytree(base, w)
    write_xlist(os.path.join(w, "fuse.lst"),
                [[os.path.join(w, "scores.nist")],
                 [os.path.join(w, "scores2.nist")]])
    write_xlist(os.path.join(w, "train.ndx"),
                [["A", os.path.join(w, "a0.sym"), os.path.join(w, "a1.sym")],
                 ["B", os.path.join(w, "b0.sym")]])
    write_xlist(os.path.join(w, "test.lst"),
                [[os.path.join(w, "t0.sym")], [os.path.join(w, "t1.sym")]])
    write_xlist(os.path.join(w, "labels.lst"),
                [[os.path.join(w, "l0.lbl")], [os.path.join(w, "l1.lbl")]])
    write_xlist(os.path.join(w, "feat.lst"), [[f"f{i}"] for i in range(4)])
    write_xlist(os.path.join(w, "models.lst"), [["c0"], ["c1"], ["c2"]])
    return w


def _feat(w, **extra):
    return dict({"featureFilesPath": w + "/", "labelFilesPath": w + "/",
                 "mixtureFilesPath": w + "/", "loadFeatureFileFormat": "SPRO4",
                 "loadFeatureFileExtension": ".prm",
                 "addDefaultLabel": "true", "defaultLabel": "speech",
                 "labelSelectedFrames": "speech"}, **extra)


# case → (tool, config of a work dir, [(output file, how to compare)])
CASES = {
    "Scoring": ("Scoring", lambda w: {
        "inputFile": f"{w}/scores.nist", "outputFile": f"{w}/out.nist",
        "decisionThreshold": 0.2}, [("out.nist", "text")]),
    "Scoring[ident]": ("Scoring", lambda w: {
        "inputFile": f"{w}/scores.nist", "outputFile": f"{w}/out.nist",
        "scoringMode": "identification"}, [("out.nist", "text")]),
    "Scoring[NIST]": ("Scoring", lambda w: {
        "inputFile": f"{w}/scores.nist", "outputFile": f"{w}/out.nist",
        "mode": "NIST", "segTypeTest": "1side", "trainTypeTest": "1side",
        "adaptationMode": "n", "threshold": 0.5}, [("out.nist", "text")]),
    "FusionScore": ("FusionScore", lambda w: {
        "inputFileList": f"{w}/fuse.lst", "weights": f"{w}/weights.txt",
        "outputFile": f"{w}/out.nist"}, [("out.nist", "text")]),
    "ScoreWarp": ("ScoreWarp", lambda w: {
        "inputFile": f"{w}/scores.nist", "outputFile": f"{w}/out.nist",
        "nbBins": 20}, [("out.nist", "text")]),
    "Hist": ("Hist", lambda w: {
        "inputFile": f"{w}/scores.nist", "outputFile": f"{w}/out.hist",
        "nbBins": 8}, [("out.hist", "text")]),
    "ModelToSv": ("ModelToSv", lambda w: {
        "mixtureFilesPath": w + "/", "vectorFilesPath": w + "/",
        "inputModelList": f"{w}/models.lst", "inputWorldFilename": "wld",
        "normSv": "true"},
        [(f"c{i}.vect", "matrix") for i in range(3)]),
    "NAPSV": ("NAPSV", lambda w: {
        "napMatrix": f"{w}/U.mat", "inputVectorList": f"{w}/vec.lst",
        "vectorFilesPath": w + "/"},
        [(f"s{s}_{j}.napped.vect", "matrix") for s in range(N_SPK)
         for j in range(SESS)]),
    "CovIntra": ("CovIntra", lambda w: {
        "ndx": f"{w}/spk.ndx", "vectorFilesPath": w + "/",
        "nbEigenVectors": 2, "channelMatrix": f"{w}/nap.mat"},
        [("nap.mat", "subspace")]),
    "ReadFeatFile": ("ReadFeatFile", lambda w: {
        "inputFeatureFilename": f"{w}/f1.prm"}, [("", "stdout")]),
    "ReadModel": ("ReadModel", lambda w: {
        "mixtureFilesPath": w + "/", "inputModelFilename": "c1"},
        [("", "stdout")]),
    "ExtractParams": ("ExtractParams", lambda w: _feat(
        w, inputFeatureFilename=f"{w}/feat.lst", featureServerMask="0-3"),
        [(f"f{i}.ext.prm", "features") for i in range(4)]),
    "PolyExp": ("PolyExp", lambda w: _feat(
        w, inputFeatureFilename=f"{w}/feat.lst", vectorFilesPath=w + "/",
        format="SVMLight"),
        [(f"f{i}.exp.vect", "svmlight") for i in range(4)]),
    "PolyExp[computeR]": ("PolyExp", lambda w: _feat(
        w, inputFeatureFilename=f"{w}/feat.lst", computeR=f"{w}/R.txt"),
        [("R.txt", "numbers")]),
    "PolyExp[normalize]": ("PolyExp", lambda w: _feat(
        w, inputFeatureFilename=f"{w}/feat.lst", vectorFilesPath=w + "/",
        normalize=f"{w}/R.norm"),
        [(f"f{i}.exp.vect", "matrix") for i in range(4)]),
    "GmmTokenizer": ("GmmTokenizer", lambda w: _feat(
        w, inputFeatureFilename=f"{w}/feat.lst", inputWorldFilename="wld",
        symbolsFilesPath=w + "/"),
        [(f"f{i}.sym", "text") for i in range(4)]),
    "GmmTokenizer[confusion]": ("GmmTokenizer", lambda w: _feat(
        w, inputFeatureFilename=f"{w}/feat.lst", inputWorldFilename="wld",
        confusionMatrix="true", topDistribsCount=4,
        matrixOutputName=f"{w}/mce.mat"), [("mce.mat", "text")]),
    "BNGram": ("BNGram", lambda w: {
        "inputSymFile": f"{w}/u1.sym", "ngramOrder": 3,
        "outputFile": f"{w}/out.ngram"}, [("out.ngram", "text")]),
    "LabelNGram": ("LabelNGram", lambda w: {
        "inputFilename": "u1", "NGramFilename": f"{w}/cb.3gram",
        "NGramOrder": 3, "NGramSelected": 6, "symbolPath": w + "/",
        "labelOutputPath": w + "/"}, [("u1.sym.lbl", "text")]),
    "SequenceDecode": ("SequenceDecode", lambda w: {
        "trainList": f"{w}/train.ndx", "testList": f"{w}/test.lst",
        "ngramOrder": 2}, [("", "stdout")]),
    "SequenceExtractor": ("SequenceExtractor", lambda w: {
        "ngramFilename": f"{w}/ngram", "ngramExt": ".dta", "maxOrder": 3,
        "nbInputSymb": 5, "nbOutputSymb": 4, "outputFilename": f"{w}/dec",
        "outputInfoFilename": f"{w}/dec.info"},
        [("dec", "text"), ("dec.info", "text")]),
    "LabelFusion": ("LabelFusion", lambda w: {
        "labelFileList": f"{w}/labels.lst", "nbFrames": 300,
        "closeGap": 5, "dropShort": 3, "outputFile": f"{w}/fused.lbl"},
        [("fused.lbl", "text")]),
    "TimeCluster": ("TimeCluster", lambda w: {
        "inputFile": f"{w}/l0.lbl", "minDuration": 0.1, "begin": 0.2,
        "outputFile": f"{w}/tc.lbl"}, [("tc.lbl", "text")]),
    "SvmTrain": ("SvmTrain", lambda w: {
        "vectorFilesPath": w + "/", "backgroundList": f"{w}/bg.lst",
        "targetIdList": f"{w}/targets.ndx", "targetPenalty": 5.0},
        [(f"t{s}.svm.npz", "svm") for s in range(3)]),
    "SvmPredict": ("SvmPredict", lambda w: {
        "vectorFilesPath": w + "/", "ndxFilename": f"{w}/trials.ndx",
        "outputFilename": f"{w}/svm.nist"}, [("svm.nist", "scores")]),
}


def _numbers(path):
    with open(path) as f:
        toks = f.read().replace(":", " ").split()
    return np.array([float(t) for t in toks])


def _compare(kind, got_path, want_path, got_out, want_out):
    if kind == "stdout":
        assert got_out == want_out and got_out
        return
    if kind == "text":
        with open(got_path) as a, open(want_path) as b:
            assert a.read() == b.read()
    elif kind == "matrix":
        a, b = read_matrix_file(got_path), read_matrix_file(want_path)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())
    elif kind == "subspace":
        a, b = read_matrix_file(got_path), read_matrix_file(want_path)
        assert a.shape == b.shape
        np.testing.assert_allclose(projector(a), projector(b), atol=1e-5)
    elif kind == "features":
        np.testing.assert_array_equal(read_feature_file(got_path).data,
                                      read_feature_file(want_path).data)
    elif kind in ("svmlight", "numbers"):
        a, b = _numbers(got_path), _numbers(want_path)
        np.testing.assert_allclose(a, b, rtol=2e-5,
                                   atol=1e-6 * np.abs(b).max())
    elif kind == "svm":
        a, b = np.load(got_path), np.load(want_path)
        assert str(a["kind"]) == str(b["kind"]) == "linear"
        np.testing.assert_array_equal(a["support"], b["support"])
        # (most α sit at their bound C or C·targetPenalty)
        np.testing.assert_allclose(a["alpha_y"], b["alpha_y"], rtol=0,
                                   atol=1e-4 * np.abs(b["alpha_y"]).max())
        assert abs(float(a["bias"]) - float(b["bias"])) <= 1e-4
    elif kind == "scores":
        a, b = read_nist_scores(got_path), read_nist_scores(want_path)
        assert [(r.model, r.seg, r.decision) for r in a] \
            == [(r.model, r.seg, r.decision) for r in b]
        sa, sb = (np.array([r.score for r in x]) for x in (a, b))
        np.testing.assert_allclose(sa, sb, rtol=0,
                                   atol=1e-4 * np.abs(sb).max())
    else:
        raise AssertionError(kind)


@pytest.mark.parametrize("case", list(CASES))
def test_utility_tool_matches_jax(ut_corpus, tmp_path, capsys, case):
    """Each LIA_Utils tool (and the second modes of Scoring, PolyExp and
    GmmTokenizer) through the port's CLI entry on the CPU, against the
    JAX tool's ``main`` on a copy of the same files."""
    tool, make_cfg, outputs = CASES[case]
    jw = _workdir(ut_corpus, tmp_path, "jax")
    tw = _workdir(ut_corpus, tmp_path, "torch")
    jcfg = JConfig(make_cfg(jw))
    jcfg["utilMode"] = tmain.TOOLS[tool][1]["utilMode"]
    capsys.readouterr()
    jut.main(jcfg)
    want_out = capsys.readouterr().out.replace(jw, "<w>")
    args = [tool, "--torchDevice", "cpu"]
    for k, v in make_cfg(tw).items():
        args += [f"--{k}", str(v)]
    before = dict(launch_counts), tsvm.launch_counts["svm_dual"]
    assert tmain.main(args) == 0
    got_out = capsys.readouterr().out.replace(tw, "<w>")
    assert (dict(launch_counts), tsvm.launch_counts["svm_dual"]) == before
    for rel, kind in outputs:
        _compare(kind, os.path.join(tw, rel), os.path.join(jw, rel),
                 got_out, want_out)


def test_svm_models_load_across_packages(ut_corpus, tmp_path):
    """A model trained by the port scores in the JAX SvmPredict and one
    trained by the JAX package in the port's (the fixture's models):
    the score files agree within 1e-4 of their scale."""
    from lia_ral_tpu_torch.tools import utils_tools as tut

    w = _workdir(ut_corpus, tmp_path, "both")
    base = {"vectorFilesPath": w + "/", "ndxFilename": f"{w}/trials.ndx"}
    # JAX-trained models (the fixture's) → port SvmPredict
    tut.main(TConfig(dict(base, utilMode="svmPredict", torchDevice="cpu",
                          outputFilename=f"{w}/port.nist")))
    jut.main(JConfig(dict(base, utilMode="svmPredict",
                          outputFilename=f"{w}/jax.nist")))
    _compare("scores", f"{w}/port.nist", f"{w}/jax.nist", None, None)
    # port-trained models → JAX SvmPredict
    tut.main(TConfig({"utilMode": "svmTrain", "torchDevice": "cpu",
                      "vectorFilesPath": w + "/",
                      "backgroundList": f"{w}/bg.lst",
                      "targetIdList": f"{w}/targets.ndx"}))
    z = np.load(f"{w}/t0.svm.npz")
    assert z["kind"].dtype.kind == "U" and z["kind"].shape == ()
    jut.main(JConfig(dict(base, utilMode="svmPredict",
                          outputFilename=f"{w}/jax2.nist")))
    _compare("scores", f"{w}/jax2.nist", f"{w}/jax.nist", None, None)
    lines = read_nist_scores(f"{w}/jax2.nist")
    tgt = [r.score for r in lines if r.seg[1] == r.model[1]]
    imp = [r.score for r in lines if r.seg[1] != r.model[1]]
    assert np.mean(tgt) > np.mean(imp)


# -- the supervector modes of the GMM-UBM tools, and the GMM-SVM chain --------

def _tools(pkg):
    if pkg == "jax":
        from lia_ral_tpu.tools import compute_test, norm_feat, train_target
        return JConfig, train_target, compute_test, norm_feat, jut
    from lia_ral_tpu_torch.tools import (compute_test, norm_feat,
                                         train_target, utils_tools)
    return TConfig, train_target, compute_test, norm_feat, utils_tools


def _sv_setup(gu_corpus, tmp_path):
    """The port's trained UBM and clients (``_trained_models``) and a NAP
    matrix of rank 3 over their supervectors."""
    work = str(tmp_path / "w")
    cfg = _trained_models(gu_corpus, work)
    world = read_gmm_file(os.path.join(work, "wld.gmm"))
    u = np.linalg.qr(np.random.default_rng(41).standard_normal(
        (world[1].size, 3)))[0].T
    write_matrix_file(os.path.join(work, "U.mat"), u)
    return work, cfg


SV_MODES = {
    "TrainTarget[NAP]": ("train_target", {"NAP": "true",
                                          "NAPChannelMatrix": "U.mat"}),
    "TrainTarget[outputAdaptParam]": ("train_target",
                                      {"outputAdaptParam": "true",
                                       "superVector": "KL"}),
    "TrainTarget[SVMUBM]": ("train_target", {"outputAdaptParam": "true",
                                             "superVector": "SVMUBM"}),
    "ComputeTest[dotProduct]": ("compute_test",
                                {"computeTestMode": "dotProduct"}),
    "ComputeTest[dotProduct+nap]": ("compute_test",
                                    {"computeTestMode": "dotProduct",
                                     "napMatrix": "U.mat"}),
    "ComputeTest[nap]": ("compute_test", {"computeTestMode": "nap",
                                          "napMatrix": "U.mat"}),
    "NormFeat[featNAP]": ("norm_feat", {"mode": "featNAP",
                                        "initChannelMatrix": "U.mat"}),
}


@pytest.mark.parametrize("case", list(SV_MODES))
def test_supervector_modes_match_jax(gu_corpus, tmp_path, case):
    """TrainTarget NAP / outputAdaptParam (KL and SVMUBM), ComputeTest
    dotProduct (with and without napMatrix) / nap and NormFeat featNAP,
    both packages on the same UBM, clients and features."""
    tool, extra = SV_MODES[case]
    work, _ = _sv_setup(gu_corpus, tmp_path)
    extra = {k: os.path.join(work, v) if v == "U.mat" else v
             for k, v in extra.items()}
    d = gu_corpus
    write_xlist(os.path.join(work, "feats.lst"),
                [[f"spk{s:02d}_s2"] for s in range(4)])
    outs = {}
    for pkg in ("jax", "torch"):
        cls, tt, ct, nf, _ = _tools(pkg)
        out = os.path.join(work, pkg)
        os.makedirs(out)
        keys = dict(extra, inputWorldFilename="wld", addDefaultLabel="true",
                    defaultLabel="speech")
        if tool == "train_target":
            keys.update(targetIdList=os.path.join(d, "models.ndx"),
                        meanAdapt="true", nbTrainIt=2,
                        saveMixtureFileExtension=f".{pkg}.gmm",
                        saveVectorFilesPath=out + "/")
            outs[pkg] = tt.main(_gu_config(cls, d, work, **keys))
        elif tool == "compute_test":
            keys.update(ndxFilename=os.path.join(d, "main.ndx"),
                        outputFilename=os.path.join(out, "sc.nist"))
            outs[pkg] = ct.main(_gu_config(cls, d, work, **keys))
        else:
            keys.update(inputFeatureFilename=os.path.join(work, "feats.lst"),
                        saveFeatureFileExtension=f".{pkg}.nap.prm")
            outs[pkg] = nf.main(_gu_config(cls, d, work, **keys))
    if tool == "compute_test":
        _compare("scores", os.path.join(work, "torch", "sc.nist"),
                 os.path.join(work, "jax", "sc.nist"), None, None)
        sc = outs["torch"]
        assert len(sc) == GU_TGT * GU_TGT
        tgt = np.mean([r.score for r in sc if r.seg.startswith(r.model)])
        imp = np.mean([r.score for r in sc if not r.seg.startswith(r.model)])
        assert tgt > imp
    elif tool == "norm_feat":
        for name in outs["jax"]:
            a = read_feature_file(os.path.join(work, name + ".torch.nap.prm"))
            b = read_feature_file(os.path.join(work, name + ".jax.nap.prm"))
            np.testing.assert_allclose(a.data, b.data, rtol=2e-4, atol=2e-4)
    elif "NAP" in extra:
        for s in range(GU_SPK):
            a, b = (read_gmm_file(os.path.join(work, f"spk{s:02d}.{p}.gmm"))
                    for p in ("torch", "jax"))
            np.testing.assert_allclose(a[1], b[1], rtol=0,
                                       atol=1e-4 * np.abs(b[1]).max())
            u = read_matrix_file(os.path.join(work, "U.mat"))
            np.testing.assert_allclose(u @ a[1].ravel(), 0.0, atol=1e-4)
    else:
        for s in range(GU_SPK):
            _compare("matrix", os.path.join(work, "torch", f"spk{s:02d}.vect"),
                     os.path.join(work, "jax", f"spk{s:02d}.vect"), None, None)
            assert not os.path.exists(
                os.path.join(work, f"spk{s:02d}.torch.gmm"))


def test_gmm_svm_chain_matches_jax(gu_corpus, tmp_path):
    """TrainTarget outputAdaptParam (KL supervectors of every session) →
    CovIntra (rank 2) → NAPSV → SvmTrain (each target's sessions against
    the cohort's) → SvmPredict, in both packages from the same UBM: the
    final score files agree within 1e-4 of their scale and targets score
    above impostors."""
    work, _ = _sv_setup(gu_corpus, tmp_path)
    d = gu_corpus
    spk = [f"spk{s:02d}" for s in range(GU_SPK)]
    sessions = [f"{s}_s{j}" for s in spk for j in range(3)]
    write_xlist(os.path.join(work, "sessions.ndx"),
                [[n, n] for n in sessions])
    write_xlist(os.path.join(work, "spk.ndx"),
                [[f"{s}_s{j}" for j in range(3)] for s in spk])
    write_xlist(os.path.join(work, "all.lst"), [[n] for n in sessions])
    write_xlist(os.path.join(work, "cohort.lst"),
                [[f"{s}_s{j}.napped"] for s in spk[GU_TGT:] for j in (0, 1)])
    write_xlist(os.path.join(work, "svm_targets.ndx"),
                [[s, f"{s}_s0.napped", f"{s}_s1.napped"]
                 for s in spk[:GU_TGT]])
    write_xlist(os.path.join(work, "svm_trials.ndx"),
                [[f"{s}_s2.napped"] + spk[:GU_TGT] for s in spk[:GU_TGT]])
    scores = {}
    for pkg in ("jax", "torch"):
        cls, tt, _, _, ut = _tools(pkg)
        out = os.path.join(work, pkg)
        os.makedirs(out)
        vec = {"vectorFilesPath": out + "/", "vectorFilesExtension": ".vect"}
        tt.main(_gu_config(cls, d, work, inputWorldFilename="wld",
                           addDefaultLabel="true", defaultLabel="speech",
                           targetIdList=os.path.join(work, "sessions.ndx"),
                           meanAdapt="true", nbTrainIt=2,
                           outputAdaptParam="true", superVector="KL",
                           saveVectorFilesPath=out + "/"))
        steps = [
            dict(vec, utilMode="covIntra", ndx=os.path.join(work, "spk.ndx"),
                 nbEigenVectors=2, channelMatrix=os.path.join(out, "nap.mat")),
            dict(vec, utilMode="napSv", napMatrix=os.path.join(out, "nap.mat"),
                 inputVectorList=os.path.join(work, "all.lst")),
            dict(vec, utilMode="svmTrain",
                 backgroundList=os.path.join(work, "cohort.lst"),
                 targetIdList=os.path.join(work, "svm_targets.ndx")),
            dict(vec, utilMode="svmPredict",
                 ndxFilename=os.path.join(work, "svm_trials.ndx"),
                 outputFilename=os.path.join(out, "svm.nist"))]
        for keys in steps:
            if pkg == "torch":
                keys["torchDevice"] = "cpu"
            ut.main(cls(keys))
        scores[pkg] = os.path.join(out, "svm.nist")
    jw, tw = (os.path.join(work, p) for p in ("jax", "torch"))
    for s in spk:
        _compare("matrix", os.path.join(tw, f"{s}_s0.vect"),
                 os.path.join(jw, f"{s}_s0.vect"), None, None)
    _compare("subspace", os.path.join(tw, "nap.mat"),
             os.path.join(jw, "nap.mat"), None, None)
    _compare("scores", scores["torch"], scores["jax"], None, None)
    lines = read_nist_scores(scores["torch"])
    assert len(lines) == GU_TGT * GU_TGT
    tgt = np.mean([r.score for r in lines if r.seg.startswith(r.model)])
    imp = np.mean([r.score for r in lines if not r.seg.startswith(r.model)])
    assert tgt > imp
