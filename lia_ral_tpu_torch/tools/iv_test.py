"""IvTest: i-vector trial scoring CLI (port of lia_ral_tpu/tools/iv_test.py).

Equivalent of reference ``LIA_SpkDet/IvTest`` (IvTest.cpp:73-706): load
the trial structure (models may enrol several sessions), optional
EFR/LDA/WCCN estimated on a dev set OR loaded from saved matrices
(ivNormLoadParam, loadWccnMatrix/loadMahalanobisMatrix/load2covMatrix,
IvTest.cpp:94-126, 369-379), scoring = cosine | mahalanobis | 2cov | plda
(native, with the enrolment session counts) | pldaMean, ASCII NIST or
binary matrix score output (outputScoreFormat, IvTest.cpp:412-465).
Every matrix estimated here is written under the reference's name.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..backend.ivnorm import (DevSet, apply_efr, compute_cov_matrices,
                              compute_lda, compute_mahalanobis, compute_wccn,
                              efr_iterations)
from ..backend.plda import PldaModel, plda_llr, plda_train
from ..backend.scoring import (cosine_scores, mahalanobis_scores,
                               two_cov_scores)
from ..config import Config
from ..io.lists import read_ndx
from ..io.matrix import read_matrix_file, write_matrix_file
from ..io.nist import ScoreLine, write_nist_scores
from .common import resolve_device, setup_verbose
from .iv_norm import (efr_param_paths, load_dev_set, load_vectors,
                      save_efr_params)
from .total_variability import matrix_out_path


def _matrix_in_path(name: str, cfg: Config) -> str:
    root = cfg.get_str("matrixFilesPath", "./")
    ext = cfg.get_str("loadMatrixFilesExtension",
                      cfg.get_str("saveMatrixFilesExtension", ".matx"))
    return os.path.join(root, name + ext)


def main(cfg: Config) -> list[ScoreLine]:
    verbose = setup_verbose(cfg)
    device = resolve_device(cfg)
    # enrollment: "model file1 [file2 ...]" lines (targetIdList)
    enroll_lines = read_ndx(cfg.get_str("targetIdList"))
    # trials: "testSeg model1 model2 ..." NDX lines
    ndx = read_ndx(cfg.get_str("ndxFilename"))
    max_clients = cfg.get_int("maxTargetLine", 0)
    if max_clients:
        ndx = [(t, ms[:max_clients]) for t, ms in ndx]
    gender = cfg.get_str("gender", "M")
    # reference key is "scoring"; scoreMode kept as an alias
    mode = cfg.get_str("scoring", cfg.get_str("scoreMode", "cosine"))
    use_wccn = cfg.get_bool("wccn", False)
    load_wccn = use_wccn and cfg.get_bool("loadWccnMatrix", False)
    load_maha = (mode == "mahalanobis"
                 and cfg.get_bool("loadMahalanobisMatrix", False))
    load_2cov = mode == "2cov" and cfg.get_bool("load2covMatrix", False)
    iv_norm = cfg.get_bool("ivNorm", False)
    load_efr = iv_norm and cfg.get_bool("ivNormLoadParam", False)

    def load_matrix(name: str) -> torch.Tensor:
        return torch.as_tensor(read_matrix_file(_matrix_in_path(name, cfg)),
                               dtype=torch.float32, device=device)

    def save_matrix(name: str, mat: torch.Tensor) -> None:
        write_matrix_file(matrix_out_path(name, cfg),
                          mat.cpu().numpy().astype(np.float64))

    # a dev set is only needed when something must be ESTIMATED
    # (IvTest.cpp:120-126)
    need_dev = ((iv_norm and not load_efr)
                or (mode == "mahalanobis" and not load_maha)
                or (use_wccn and not load_wccn)
                or (mode == "2cov" and not load_2cov))
    dev = None
    params = []
    if need_dev and cfg.exists("backgroundNdxFilename"):
        dev, _ = load_dev_set(cfg, device)
        if iv_norm and not load_efr:
            normed, params = efr_iterations(
                dev, cfg.get_int("ivNormIterationNb", 1),
                cfg.get_str("ivNormEfrMode", "EFR"))
            dev = dev.replace(vectors=normed)
            save_efr_params(params, cfg)
    if load_efr:
        # the per-iteration mean/matrix files IvNorm saved
        for it in range(cfg.get_int("ivNormIterationNb", 1)):
            mat_path, mean_path = efr_param_paths(cfg, it, _matrix_in_path)
            params.append((
                torch.as_tensor(read_matrix_file(mean_path).ravel(),
                                dtype=torch.float32, device=device),
                torch.as_tensor(read_matrix_file(mat_path),
                                dtype=torch.float32, device=device)))

    def vectors(names: list[str]) -> torch.Tensor:
        x = torch.as_tensor(load_vectors(names, cfg), device=device)
        return apply_efr(x, params) if params else x

    model_names = [m for m, _ in enroll_lines]
    enroll = torch.stack([torch.mean(vectors(files if files else [m]), dim=0)
                          for m, files in enroll_lines])
    n_sessions = [len(files) if files else 1 for _, files in enroll_lines]
    seg_names = list(dict.fromkeys(t for t, _ in ndx))
    segs = vectors(seg_names)

    proj = None
    if cfg.exists("ldaRank") and dev is not None:
        proj = compute_lda(dev, cfg.get_int("ldaRank"))
        if cfg.exists("ldaMatrix"):
            save_matrix(cfg.get_str("ldaMatrix"), proj)
        dev = dev.replace(vectors=dev.vectors @ proj.T)
    elif cfg.exists("ldaMatrix") and cfg.get_bool("LDA", False):
        proj = load_matrix(cfg.get_str("ldaMatrix"))
    if proj is not None:
        enroll = enroll @ proj.T
        segs = segs @ proj.T

    two_cov_base = cfg.get_str("TwoCovFilename", "2Cov")
    if mode == "cosine":
        wccn = None
        if load_wccn:
            wccn = load_matrix(cfg.get_str("wccnMatrix", "wccnMatrix"))
        elif use_wccn and dev is not None:
            wccn = compute_wccn(dev)
            if cfg.exists("wccnMatrix"):
                save_matrix(cfg.get_str("wccnMatrix"), wccn)
        scores = cosine_scores(enroll, segs, wccn=wccn)
    elif mode == "mahalanobis":
        if load_maha:
            maha = load_matrix(cfg.get_str("mahalanobisMatrix",
                                           "mahalanobisMatrix"))
        else:
            assert dev is not None, "mahalanobis needs backgroundNdxFilename"
            maha = compute_mahalanobis(dev)
            if cfg.exists("mahalanobisMatrix"):
                save_matrix(cfg.get_str("mahalanobisMatrix"), maha)
        scores = mahalanobis_scores(enroll, segs, maha)
    elif mode == "2cov":
        if load_2cov:
            # saved as <TwoCovFilename>_W / _B (IvTest.cpp:369-379)
            w = load_matrix(two_cov_base + "_W")
            b = load_matrix(two_cov_base + "_B")
            mean = torch.zeros(enroll.shape[1], device=device)
        else:
            assert dev is not None, "2cov needs backgroundNdxFilename"
            _, w, b = compute_cov_matrices(dev)
            mean = torch.mean(dev.vectors, dim=0)
            save_matrix(two_cov_base + "_W", w)
            save_matrix(two_cov_base + "_B", b)
        scores = two_cov_scores(enroll - mean, segs - mean, w, b)
    elif mode in ("plda", "pldaMean"):
        if cfg.exists("pldaModelFilename"):
            plda = PldaModel.load(cfg.get_str("pldaModelFilename"),
                                  device=device)
        else:
            assert dev is not None, "plda needs a model or a dev set"
            gen = torch.Generator(device=device).manual_seed(
                cfg.get_int("randomSeed", 0))
            plda = plda_train(gen, dev,
                              cfg.get_int("pldaEigenVoiceNumber", 150),
                              cfg.get_int("pldaEigenChannelNumber", 0),
                              cfg.get_int("pldaNbIt", 10), verbose)
        ns = (torch.as_tensor(n_sessions, dtype=torch.float32, device=device)
              if mode == "plda"
              else torch.ones(len(model_names), device=device))
        scores = plda_llr(plda, enroll, ns, segs)
    else:
        raise ValueError(f"unknown scoring mode {mode}")

    scores = scores.cpu().numpy()
    seg_idx = {s: i for i, s in enumerate(seg_names)}
    mod_idx = {m: i for i, m in enumerate(model_names)}
    threshold = cfg.get_float("decisionThreshold", 0.0)
    results = []
    for test_name, models in ndx:
        for m in models:
            sc = float(scores[mod_idx[m], seg_idx[test_name]])
            results.append(ScoreLine(gender, m,
                                     "1" if sc > threshold else "0",
                                     test_name, sc))
    out_name = cfg.get_str("outputFilename")
    if cfg.get_str("outputScoreFormat", "ascii") == "binary":
        # binary mode (IvTest.cpp:441-465): model/segment name lists +
        # the full (M,S) score matrix in .matx format
        with open(out_name + "_model.txt", "w") as f:
            f.write("".join(m + "\n" for m in model_names))
        with open(out_name + "_testSeg.txt", "w") as f:
            f.write("".join(s + "\n" for s in seg_names))
        write_matrix_file(
            out_name + cfg.get_str("saveMatrixFilesExtension", ".matx"),
            scores.astype(np.float64))
    else:
        write_nist_scores(out_name, results)
    if verbose:
        print(f"scored {len(results)} trials ({mode})")
    return results


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
