"""IvTest: i-vector trial scoring CLI (port of lia_ral_tpu/tools/iv_test.py,
cosine scoring).

Equivalent of reference ``LIA_SpkDet/IvTest`` (IvTest.cpp:73-706) with
``scoring=cosine``: models enrol the mean of their sessions' i-vectors,
every trial of the NDX gets the cosine of its model and test vectors,
written as ASCII NIST lines or as the binary score matrix
(``outputScoreFormat``, IvTest.cpp:412-465).  The other scoring modes and
the normalisations (ivNorm, WCCN, LDA) are not ported yet.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..backend.scoring import cosine_scores
from ..config import Config
from ..io.lists import read_ndx
from ..io.matrix import write_matrix_file
from ..io.nist import ScoreLine, write_nist_scores
from .common import resolve_device, setup_verbose
from .iv_norm import load_vectors

_NOT_PORTED = ("is not ported to lia_ral_tpu_torch yet (ROADMAP queue 1, "
               "item 9); the port's IvTest scores cosine without "
               "normalisation")


def main(cfg: Config) -> list[ScoreLine]:
    # reference key is "scoring"; scoreMode kept as an alias
    mode = cfg.get_str("scoring", cfg.get_str("scoreMode", "cosine"))
    if mode != "cosine":
        raise NotImplementedError(f"scoring={mode} {_NOT_PORTED}")
    for key in ("ivNorm", "wccn", "LDA"):
        if cfg.get_bool(key, False):
            raise NotImplementedError(f"{key} {_NOT_PORTED}")
    verbose = setup_verbose(cfg)
    dev = resolve_device(cfg)
    # enrollment: "model file1 [file2 ...]" lines (targetIdList)
    enroll_lines = read_ndx(cfg.get_str("targetIdList"))
    # trials: "testSeg model1 model2 ..." NDX lines
    ndx = read_ndx(cfg.get_str("ndxFilename"))
    max_clients = cfg.get_int("maxTargetLine", 0)
    if max_clients:
        ndx = [(t, ms[:max_clients]) for t, ms in ndx]
    gender = cfg.get_str("gender", "M")

    def vectors(names: list[str]) -> torch.Tensor:
        return torch.as_tensor(load_vectors(names, cfg), device=dev)

    model_names = [m for m, _ in enroll_lines]
    enroll = torch.stack([torch.mean(vectors(files if files else [m]), dim=0)
                          for m, files in enroll_lines])
    seg_names = list(dict.fromkeys(t for t, _ in ndx))
    scores = cosine_scores(enroll, vectors(seg_names)).cpu().numpy()

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
