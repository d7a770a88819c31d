"""LIA_Utils CLI tools (SURVEY.md §2.4) behind one dispatcher (port of
lia_ral_tpu/tools/utils_tools.py).

Modes (utilMode config key) and their reference binaries:
scoring | fusion (FusionScore) | scoreWarp | hist | modelToSv | napSv |
covIntra | readFeatFile | readModel | extractParams | polyExp |
sequenceExtract | gmmTokenizer | bNgram | labelNgram | sequenceDecode |
labelFusion | timeCluster | svmTrain | svmPredict (Svm).

The config keys and output files are the JAX tool's; a ``.svm.npz`` model
written by either package loads in the other.  Modes that only move
scores, labels, symbols or files stay numpy on the host; polyExp,
gmmTokenizer, covIntra, napSv, svmTrain and svmPredict compute on the
tool's device (``torchDevice``, default ``cuda``).  svmTrain trains one
target at a time, so each target is one launch of the SVM dual kernel
on the card.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..backend.supervector import (model_to_sv, nap_project_vectors,
                                   train_nap_subspace)
from ..backend.svm import SvmModel, svm_train
from ..config import Config
from ..gmm.kernels import weighted_logdens
from ..gmm.model import GmmDiag
from ..io.features import read_feature_file, write_feature_file
from ..io.labels import Segment, read_label_file, write_label_file
from ..io.lists import read_ndx, read_simple_list, read_xlist
from ..io.matrix import read_matrix_file, write_matrix_file
from ..io.nist import (ScoreLine, format_nist04_line, read_nist_scores,
                       write_nist_scores)
from ..utils import (NGramModel, fuse_label_files, fuse_scores, gmm_tokenize,
                     histogram, label_ngram, max_score_identification,
                     ngram_counts, poly_expand, read_ngram_codebook,
                     score_warp, scoring_decisions, sequence_decode,
                     time_cluster_filter)
from ..utils.polyexp import glds_expand_mean
from ..utils.seqtree import CommonPartTree, sequence_extractor
from .common import (load_features_and_mask, mixture_path, resolve_device,
                     resolve_list)


def scoring_main(cfg: Config):
    """Scoring post-processing.  ``mode NIST`` reproduces the reference's
    LIA→NIST04 conversion (Scoring.cpp:243-274): per line, decision =
    score > ``threshold`` → 't'/'f' (or max-score per segment with
    decision "true" under ``hardDecision``), written as
    "trainTypeTest adaptationMode segTypeTest gender model seg dec score"
    (the in-tree golden ``score.final.nist``)."""
    lines = read_nist_scores(cfg.get_str("inputFile"))
    if cfg.get_str("mode", "") == "NIST":
        seg_t = cfg.get_str("segTypeTest")
        train_t = cfg.get_str("trainTypeTest")
        adapt = cfg.get_str("adaptationMode")
        out_lines = []
        if cfg.exists("hardDecision"):
            by_seg: dict[str, list] = {}
            for ln in lines:
                by_seg.setdefault(ln.seg, []).append(ln)
            for ln in (max(v, key=lambda s: s.score)
                       for v in by_seg.values()):
                out_lines.append(format_nist04_line(
                    train_t, adapt, seg_t, ln.gender.lower(), ln.model,
                    ln.seg, "true", ln.score))
        else:
            thr = cfg.get_float("threshold", 0.0)
            for ln in lines:
                out_lines.append(format_nist04_line(
                    train_t, adapt, seg_t, ln.gender.lower(), ln.model,
                    ln.seg, "t" if ln.score > thr else "f", ln.score))
        with open(cfg.get_str("outputFile"), "w", encoding="utf-8") as f:
            for t in out_lines:
                f.write(t + "\n")
        return out_lines
    if cfg.get_str("scoringMode", "decision") == "identification":
        out = max_score_identification(lines)
    else:
        out = scoring_decisions(lines, cfg.get_float("decisionThreshold", 0.0))
    write_nist_scores(cfg.get_str("outputFile"), out)
    return out


def fusion_main(cfg: Config):
    """FusionScore (reference CLI keys ``inputFileList``/``weights``/
    ``fusionMethod ArithMean``)."""
    files = read_simple_list(cfg.get_str(
        "inputFileList" if cfg.exists("inputFileList") else "fusionList"))
    wkey = "weights" if cfg.exists("weights") else "weightsFile"
    with open(cfg.get_str(wkey), "r", encoding="utf-8") as f:
        weights = [float(w) for w in f.read().split()]
    out = fuse_scores([read_nist_scores(f) for f in files], weights)
    write_nist_scores(cfg.get_str("outputFile"), out)
    return out


def score_warp_main(cfg: Config):
    lines = read_nist_scores(cfg.get_str("inputFile"))
    warped = score_warp(np.asarray([l.score for l in lines]),
                        target_mean=cfg.get_float("targetMean", 0.0),
                        target_std=cfg.get_float("targetStd", 1.0),
                        nb_bins=cfg.get_int("nbBins", 100))
    out = [ScoreLine(l.gender, l.model, l.decision, l.seg, float(s),
                     begin=l.begin, end=l.end)
           for l, s in zip(lines, warped)]
    write_nist_scores(cfg.get_str("outputFile"), out)
    return out


def hist_main(cfg: Config):
    lines = read_nist_scores(cfg.get_str("inputFile"))
    hist, edges = histogram(np.asarray([l.score for l in lines]),
                            cfg.get_int("nbBins", 100))
    with open(cfg.get_str("outputFile"), "w") as f:
        for h, lo, hi in zip(hist, edges[:-1], edges[1:]):
            f.write(f"{lo:g} {hi:g} {h:g}\n")
    return hist, edges


def model_to_sv_main(cfg: Config):
    """ModelToSv (ModelToSvMain.cpp:77-166): GMM → supervector files.

    * ``meanSv``  — sv = stacked component means; the ``normSv``
      normalisation vector is √(w_i·covInv_ij) of the UBM
      (getMeanNorm, cpp:58-68 — the KL-kernel scaling);
    * ``weightSv`` — sv = component weights; norm = 1/√(w_i)
      (getWeightNorm, cpp:70-75);
    * ``vectors`` — read existing .vect files instead of models and only
      apply the normalisation (cpp:147-156);
    * ``normSv`` (alias ``normalizeSv``) multiplies elementwise by the
      UBM-derived norm vector (cpp:157-160).
    On the host, in float64 as the JAX tool.
    """
    weight_sv = cfg.get_bool("weightSv", False)
    norm_sv = (cfg.get_bool("normSv", False)
               or cfg.get_bool("normalizeSv", False))
    from_vectors = cfg.get_bool("vectors", False)
    if cfg.exists("inputModelList"):
        names = resolve_list(cfg, "inputModelList")
    elif cfg.exists("inputFilename"):
        names = resolve_list(cfg, "inputFilename")
    else:
        names = [cfg.get_str("inputModelFilename")]
    vpath = cfg.get_str("vectorFilesPath", "./")
    vext = cfg.get_str("vectorFilesExtension", ".vect")
    norm_vec = None
    if norm_sv:
        ubm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"),
                                        cfg))
        w = ubm.weights.numpy().astype(np.float64)
        if weight_sv:
            norm_vec = 1.0 / np.sqrt(w)
        else:
            ci = ubm.cov_inv.numpy().astype(np.float64)
            norm_vec = np.sqrt(w[:, None] * ci).ravel()
    out = {}
    for n in names:
        if from_vectors:
            iext = cfg.get_str("inputVectorFilesExtension", ".sv")
            sv = read_matrix_file(os.path.join(vpath, n + iext)) \
                .ravel().astype(np.float64)
        else:
            gmm = GmmDiag.load(mixture_path(n, cfg))
            sv = (gmm.weights if weight_sv else model_to_sv(gmm)) \
                .numpy().astype(np.float64)
        if norm_vec is not None:
            sv = sv * norm_vec
        write_matrix_file(os.path.join(vpath, n + vext), sv[None, :])
        out[n] = sv
    return out


def nap_sv_main(cfg: Config):
    """NAPSV: the ``napMatrix`` subspace projected out of each listed
    vector, written as <name>.napped<ext>; on the tool's device."""
    dev = resolve_device(cfg)
    u = torch.as_tensor(read_matrix_file(cfg.get_str("napMatrix")),
                        dtype=torch.float32, device=dev)
    root = cfg.get_str("vectorFilesPath", "./")
    ext = cfg.get_str("vectorFilesExtension", ".vect")
    out = {}
    for n in read_simple_list(cfg.get_str("inputVectorList")):
        v = torch.as_tensor(read_matrix_file(os.path.join(root, n + ext)),
                            dtype=torch.float32, device=dev)
        napped = nap_project_vectors(v, u).cpu().numpy().astype(np.float64)
        write_matrix_file(os.path.join(root, n + ".napped" + ext), napped)
        out[n] = napped
    return out


def read_feat_main(cfg: Config):
    ff = read_feature_file(
        cfg.get_str("inputFeatureFilename"),
        fmt=cfg.get_str("loadFeatureFileFormat", "SPRO4"),
        big_endian=cfg.get_bool("bigEndian", False),
        vect_size=cfg.get_int("loadFeatureFileVectSize", 0))
    for row in ff.data:
        print(" ".join(f"{v:g}" for v in row))
    return ff


def read_model_main(cfg: Config):
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputModelFilename"), cfg))
    print(f"MixtureGD distribCount={gmm.n_components} vectSize={gmm.dim}")
    w, m, ci = (t.numpy() for t in (gmm.weights, gmm.means, gmm.cov_inv))
    for i in range(gmm.n_components):
        print(f"distrib {i} weight={w[i]:g}")
        print("  mean " + " ".join(f"{v:g}" for v in m[i]))
        print("  covInv " + " ".join(f"{v:g}" for v in ci[i]))
    return gmm


def extract_params_main(cfg: Config):
    out = {}
    for n in resolve_list(cfg, "inputFeatureFilename"):
        fs, _ = load_features_and_mask([n], cfg)
        write_feature_file(
            os.path.join(cfg.get_str("featureFilesPath", "./"),
                         n + cfg.get_str("saveFeatureFileExtension",
                                         ".ext.prm")),
            fs.data, fmt=cfg.get_str("saveFeatureFileFormat", "SPRO4"))
        out[n] = fs.data
    return out


def poly_exp_main(cfg: Config):
    """PolyExpand (PolyExpand.cpp:164-211), on the tool's device.  Three
    modes driven by the reference's own config keys:
      default     — per file, mean order-3 expansion over the selected
                    frames, written per ``format`` (SVMLight: "exType
                    1:v1 2:v2 ..." — outputInstanceSVMLight cpp:147-156)
      computeR    — accumulate E[e²]/mean over ALL files (no per-file
                    reset, cpp:193-207) and write "1/sqrt(E[e_i²])
                    mean_i" lines to the ``computeR`` path (cpp:131-146)
      normalize F — load the R file and multiply each output vector
                    elementwise by its first column (cpp:118-122)
    The (N, 11,480) expansion of a D=39 file stays on the device; only
    the two accumulator vectors or the mean expansion come back."""
    dev = resolve_device(cfg)
    names = resolve_list(cfg, "inputFeatureFilename")
    compute_r = cfg.exists("computeR")
    r_vec = None
    if cfg.exists("normalize"):
        rows = []
        with open(cfg.get_str("normalize")) as f:
            for line in f:
                parts = line.split()
                if parts:
                    rows.append(float(parts[0]))
        r_vec = np.asarray(rows, np.float64)
    fmt = cfg.get_str("format", "matx")
    ex_type = cfg.get_str("exType", "1")
    vext = cfg.get_str("vectorFilesExtension", ".exp.vect")
    out = {}
    acc_sum = acc_sq = acc_cnt = None
    for n in names:
        fs, mask = load_features_and_mask([n], cfg)
        x = torch.as_tensor(fs.data, device=dev)
        w = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        if compute_r:
            # FrameAccGD over the whole list (reset only at the end)
            e = poly_expand(x)
            s1 = torch.sum(e * w[:, None], dim=0).cpu().numpy()
            s2 = torch.sum(e * e * w[:, None], dim=0).cpu().numpy()
            del e
            if acc_sum is None:
                acc_sum, acc_sq, acc_cnt = (s1.astype(np.float64),
                                            s2.astype(np.float64), 0.0)
            else:
                acc_sum += s1
                acc_sq += s2
            acc_cnt += float(torch.sum(w))
            continue
        v = glds_expand_mean(x, w).cpu().numpy().astype(np.float64)
        if r_vec is not None:
            v = v * r_vec
        path = os.path.join(cfg.get_str("vectorFilesPath", "./"), n + vext)
        if fmt == "SVMLight":
            with open(path, "w") as f:
                f.write(ex_type + " "
                        + " ".join(f"{i + 1}:{x_:g}" for i, x_ in enumerate(v))
                        + " \n")
        else:
            write_matrix_file(path, v[None, :])
        out[n] = v
    if compute_r:
        if acc_sum is None:
            raise ValueError("polyExp computeR: empty input file list")
        mean = acc_sum / max(acc_cnt, 1e-30)
        msq = acc_sq / max(acc_cnt, 1e-30)
        # computeRSqrt cpp:131-136; identically-zero columns would give
        # inf — normalise them by 1 instead (they carry no information)
        r = np.where(msq > 0, 1.0 / np.sqrt(np.maximum(msq, 1e-300)), 1.0)
        with open(cfg.get_str("computeR"), "w") as f:
            for ri, mi in zip(r, mean):
                f.write(f"{ri:g} {mi:g}\n")
            f.write("\n")
        out["R"] = np.stack([r, mean])
    return out


def sequence_extract_main(cfg: Config):
    """SequenceExtractor (SequenceExtractor.cpp:732-827): load ngram
    files of order 1..maxOrder into a common-part tree, greedily carve
    nbOutputSymb equal-probability variable-length sequences, save the
    decoder tree + an info file."""
    tree = CommonPartTree.from_ngram_files(
        cfg.get_str("ngramFilename"), cfg.get_str("ngramExt", ".dta"),
        cfg.get_int("maxOrder"), cfg.get_int("maxNgram", 1 << 30))
    dec, info = sequence_extractor(
        tree, cfg.get_int("nbInputSymb"), cfg.get_int("nbOutputSymb"),
        equal_input_info=cfg.get_bool("equalInputInfo", False),
        verbose=cfg.get_bool("verbose", False))
    if cfg.exists("outputFilename"):
        with open(cfg.get_str("outputFilename"), "w") as f:
            dec.save(f)
    if cfg.exists("outputInfoFilename"):
        with open(cfg.get_str("outputInfoFilename"), "w") as f:
            for seq_id, count in info:
                f.write(f"{seq_id} {count}\n")
    return dec, info


def cov_intra_main(cfg: Config):
    """CovIntra (CovIntra.cpp:151-280): train the NAP / within-speaker
    covariance subspace from session supervectors, on the tool's device.

    NDX lines = one speaker per line, elements = that speaker's session
    vectors; ``gmm true`` loads GMM files and stacks their means
    (loadMeanSv, cpp:107-118) instead of .vect files.  The top
    ``nbEigenVectors`` eigenvectors of the within-class scatter are saved
    to ``channelMatrix``."""
    dev = resolve_device(cfg)
    lines = read_xlist(cfg.get_str("ndx"))
    from_gmm = cfg.get_bool("gmm", False)
    vpath = cfg.get_str("vectorFilesPath", "./")
    vext = cfg.get_str("vectorFilesExtension", ".vect")
    vecs, spk_ids = [], []
    for spk, line in enumerate(lines):
        for name in line:
            if from_gmm:
                sv = model_to_sv(GmmDiag.load(mixture_path(name, cfg))) \
                    .numpy().astype(np.float64)
            else:
                sv = read_matrix_file(os.path.join(vpath, name + vext)) \
                    .ravel().astype(np.float64)
            vecs.append(sv)
            spk_ids.append(spk)
    v = torch.as_tensor(np.stack(vecs), dtype=torch.float32, device=dev)
    nap = train_nap_subspace(v, torch.as_tensor(spk_ids, device=dev),
                             len(lines), cfg.get_int("nbEigenVectors", 40))
    nap = nap.cpu().numpy()
    write_matrix_file(cfg.get_str("channelMatrix"), nap)
    return nap


def gmm_tokenizer_main(cfg: Config):
    """GmmTokenizer symbolsExtract mode (GmmTokenizer.cpp:171-208), on
    the tool's device: winning component per selected frame, consecutive
    repeats collapsed (``duration true`` keeps repeats,
    GmmTokenizerMain.cpp:73).  ``confusionMatrix true`` switches to
    GaussianConfusionMatrix (cpp:128-160): counts of (best, i-th best)
    over topDistribsCount."""
    dev = resolve_device(cfg)
    world_key = ("inputWorldModelName"
                 if cfg.exists("inputWorldModelName") else "inputWorldFilename")
    gmm = GmmDiag.load(mixture_path(cfg.get_str(world_key), cfg), device=dev)
    names = resolve_list(cfg, "inputFeatureFilename")
    sym_dir = cfg.get_str("symbolsFilesPath", cfg.get_str("symFilesPath", "./"))
    if cfg.get_bool("confusionMatrix", False):
        n_best = cfg.get_int("topDistribsCount", 10)
        k = gmm.n_components
        mce = np.zeros((k, k), np.int64)
        for n in names:
            fs, mask = load_features_and_mask([n], cfg)
            ld = weighted_logdens(torch.as_tensor(fs.data[mask > 0],
                                                  device=dev), gmm)
            idx = torch.topk(ld, min(n_best, k), dim=-1).indices.cpu().numpy()
            np.add.at(mce, (np.repeat(idx[:, 0], idx.shape[1]),
                            idx.ravel()), 1)
        with open(cfg.get_str("matrixOutputName", "mce_matrix.mat"), "w",
                  encoding="utf-8") as f:
            f.write(f"{k} {k}\n")
            for row in mce:
                f.write(" ".join(str(int(v)) for v in row) + " \n")
        return mce
    keep_repeats = cfg.get_bool("duration", False)
    out = {}
    for n in names:
        fs, mask = load_features_and_mask([n], cfg)
        syms = gmm_tokenize(torch.as_tensor(fs.data, device=dev), gmm)
        syms = syms[mask > 0]
        if not keep_repeats and syms.size:
            syms = syms[np.concatenate([[True], np.diff(syms) != 0])]
        with open(os.path.join(sym_dir, n + ".sym"), "w") as f:
            f.write(" ".join(str(int(s)) for s in syms) + "\n")
        out[n] = syms
    return out


def bngram_main(cfg: Config):
    syms = read_simple_list(cfg.get_str("inputSymFile"))
    counts = ngram_counts(syms, cfg.get_int("ngramOrder", 2))
    with open(cfg.get_str("outputFile"), "w") as f:
        for gram, c in counts.most_common():
            f.write(" ".join(gram) + f" {c}\n")
    return counts


def sequence_decode_main(cfg: Config):
    """Train per-class n-gram models from 'class symfile' lines, decode
    test symbol files (SequenceExtractor + SequenceDecoder)."""
    order = cfg.get_int("ngramOrder", 2)
    by_class: dict[str, list] = {}
    for cls, files in read_ndx(cfg.get_str("trainList")):
        for fp in files:
            by_class.setdefault(cls, []).append(read_simple_list(fp))
    models = {cls: NGramModel.train(seqs, order)
              for cls, seqs in by_class.items()}
    results = {}
    for name in read_simple_list(cfg.get_str("testList")):
        best, scores = sequence_decode(read_simple_list(name), models)
        results[name] = (best, scores)
        print(f"{name} {best} " + " ".join(
            f"{c}:{s:.4f}" for c, s in scores.items()))
    return results


def label_ngram_main(cfg: Config):
    """Transform a per-frame token stream into a label file via a
    bag-of-ngram codebook (reference LabelNGram, LabelNGramMain.cpp
    schema: inputFilename/NGramFilename/NGramOrder/NGramSelected/
    symbolPath/symbolFileExtension/labelOutputPath/
    saveLabelFileExtension)."""
    order = cfg.get_int("NGramOrder", 3)
    codebook = read_ngram_codebook(cfg.get_str("NGramFilename"), order,
                                   cfg.get_int("NGramSelected", 16))
    name = cfg.get_str("inputFilename")
    syms = read_simple_list(os.path.join(
        cfg.get_str("symbolPath", "./"),
        name + cfg.get_str("symbolFileExtension", ".sym")))
    frame_length = cfg.get_float("frameLength", 0.01)
    segs = None
    if cfg.exists("labelInputPath"):
        lbl = read_label_file(os.path.join(
            cfg.get_str("labelInputPath"),
            name + cfg.get_str("labelFileExtension", ".lbl")))
        segs = [s.frames(frame_length) for s in lbl]
    spans = label_ngram(syms, codebook, order, segments=segs)
    out = [Segment(b * frame_length, e * frame_length, lab)
           for b, e, lab in spans]
    write_label_file(os.path.join(
        cfg.get_str("labelOutputPath", "./"),
        name + cfg.get_str("saveLabelFileExtension", ".sym.lbl")), out)
    return out


def label_fusion_main(cfg: Config):
    seg_lists = [read_label_file(f)
                 for f in read_simple_list(cfg.get_str("labelFileList"))]
    out = fuse_label_files(
        seg_lists, cfg.get_int("nbFrames"),
        frame_length=cfg.get_float("frameLength", 0.01),
        mode=cfg.get_str("fusionMode", "union"),
        label=cfg.get_str("labelOutputFrames", "speech"),
        close_gap=cfg.get_int("closeGap", 0),
        drop_short=cfg.get_int("dropShort", 0))
    write_label_file(cfg.get_str("outputFile"), out)
    return out


def time_cluster_main(cfg: Config):
    out = time_cluster_filter(
        read_label_file(cfg.get_str("inputFile")),
        min_duration=cfg.get_float("minDuration", 0.0),
        begin=cfg.get_float("begin") if cfg.exists("begin") else None,
        end=cfg.get_float("end") if cfg.exists("end") else None,
        labels=cfg.get_str("keepLabels").split(",")
        if cfg.exists("keepLabels") else None)
    write_label_file(cfg.get_str("outputFile"), out)
    return out


def svm_train_main(cfg: Config):
    """Train one SVM per target: target supervector(s) vs cohort
    (reference Svm tool, GmmSv configs), each on the tool's device; the
    model is saved as <target>.svm.npz (the JAX tool's format: ``kind``
    a 0-d string array, loadable without pickle)."""
    dev = resolve_device(cfg)
    root = cfg.get_str("vectorFilesPath", "./")
    ext = cfg.get_str("vectorFilesExtension", ".vect")

    def load(names):
        return np.stack([read_matrix_file(os.path.join(root, n + ext)).ravel()
                         for n in names]).astype(np.float32)

    cohort = torch.from_numpy(
        load(read_simple_list(cfg.get_str("backgroundList")))).to(dev)
    n_coh = cohort.shape[0]
    out = {}
    for target, files in read_ndx(cfg.get_str("targetIdList")):
        tv = torch.from_numpy(load(files if files else [target])).to(dev)
        y = np.r_[np.ones(tv.shape[0]), -np.ones(n_coh)].astype(np.float32)
        model = svm_train(
            torch.cat([tv, cohort]), y,
            c=cfg.get_float("C") if cfg.exists("C") else None,
            target_penalty=cfg.get_float("targetPenalty")
            if cfg.exists("targetPenalty") else None,
            kind={0: "linear", 1: "poly", 2: "rbf"}.get(
                cfg.get_int("kernelType", 0), "linear")).host()
        np.savez(os.path.join(root, target + ".svm.npz"),
                 support=model.support, alpha_y=model.alpha_y,
                 bias=model.bias, kind=model.kind, degree=model.degree,
                 gamma=model.gamma, coef0=model.coef0)
        out[target] = model
    return out


def load_svm_model(path: str) -> SvmModel:
    z = np.load(path)
    return SvmModel(z["support"], z["alpha_y"], float(z["bias"]),
                    str(z["kind"]), int(z["degree"]), float(z["gamma"]),
                    float(z["coef0"]))


def svm_predict_main(cfg: Config):
    """Score every NDX trial (segment × model) with the models of
    svmTrain, on the tool's device.  Each model is loaded once and
    scores all the segments that name it in one decision call; the
    score file keeps the NDX order."""
    dev = resolve_device(cfg)
    root = cfg.get_str("vectorFilesPath", "./")
    ext = cfg.get_str("vectorFilesExtension", ".vect")
    ndx = read_ndx(cfg.get_str("ndxFilename"))
    segs = list(dict.fromkeys(seg for seg, _ in ndx))
    row = {seg: i for i, seg in enumerate(segs)}
    x = torch.as_tensor(np.stack([
        read_matrix_file(os.path.join(root, seg + ext)).ravel()
        for seg in segs]), dtype=torch.float32, device=dev)
    by_model: dict[str, list[str]] = {}
    for seg, models in ndx:
        for m in models:
            by_model.setdefault(m, []).append(seg)
    scores = {}
    for m, m_segs in by_model.items():
        model = load_svm_model(os.path.join(root, m + ".svm.npz"))
        dec = model.decision(x[[row[s] for s in m_segs]]).cpu().numpy()
        scores.update({(s, m): float(v) for s, v in zip(m_segs, dec)})
    gender = cfg.get_str("gender", "M")
    results = [ScoreLine(gender, m, "1" if scores[(seg, m)] > 0 else "0",
                         seg, scores[(seg, m)])
               for seg, models in ndx for m in models]
    write_nist_scores(cfg.get_str("outputFilename"), results)
    return results


MODES = {
    "scoring": scoring_main, "fusion": fusion_main,
    "scoreWarp": score_warp_main, "hist": hist_main,
    "modelToSv": model_to_sv_main, "napSv": nap_sv_main,
    "covIntra": cov_intra_main,
    "readFeatFile": read_feat_main, "readModel": read_model_main,
    "extractParams": extract_params_main, "polyExp": poly_exp_main,
    "sequenceExtract": sequence_extract_main,
    "gmmTokenizer": gmm_tokenizer_main, "bNgram": bngram_main,
    "sequenceDecode": sequence_decode_main,
    "labelNgram": label_ngram_main,
    "labelFusion": label_fusion_main, "timeCluster": time_cluster_main,
    "svmTrain": svm_train_main, "svmPredict": svm_predict_main,
}


def main(cfg: Config):
    return MODES[cfg.get_str("utilMode")](cfg)


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
