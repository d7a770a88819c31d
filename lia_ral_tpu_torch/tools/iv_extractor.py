"""IvExtractor: i-vector extraction CLI (port of
lia_ral_tpu/tools/iv_extractor.py).

Equivalent of reference ``LIA_SpkDet/IvExtractor`` (IvExtractor.cpp:70-150
exact estimateW; 151 the UbmWeight variant; 253 the EigenDecomposition
variant, selected with ``ivExtractionMode``; the two variants read the
matrices TotalVariability writes with ``approximationMode``).  Writes one
i-vector file per session (saveWbyFile parity: a 1×R .matx each), plus an
optional combined .npz (``ivectorsOutput``).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import Config
from ..fa.stats import load_stats
from ..fa.tv import (TvModel, estimate_w, estimate_w_eigen_decomposition,
                     estimate_w_ubm_weight)
from ..gmm.model import GmmDiag
from ..io.matrix import read_matrix_file, write_matrix_file
from .common import mixture_path, resolve_device, setup_verbose
from .total_variability import accumulate_stats_from_ndx, matrix_out_path


def vector_path(name: str, cfg: Config) -> str:
    root = cfg.get_str("saveVectorFilesPath", "./")
    ext = cfg.get_str("vectorFilesExtension", ".y")
    return os.path.join(root, name + ext)


def main(cfg: Config) -> dict[str, np.ndarray]:
    mode = cfg.get_str("ivExtractionMode", "exact")
    if mode not in ("exact", "ubmWeight", "eigenDecomposition"):
        raise ValueError(f"unknown ivExtractionMode {mode}")
    verbose = setup_verbose(cfg)
    dev = resolve_device(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                       device=dev)
    model = TvModel.load(matrix_out_path(
        cfg.get_str("totalVariabilityMatrix"), cfg), gmm)
    if cfg.exists("meanEstimate"):
        mean = read_matrix_file(matrix_out_path(
            cfg.get_str("meanEstimate"), cfg))
        model = model.replace(ubm_means=torch.as_tensor(
            mean.reshape(model.n_distrib, model.dim), dtype=torch.float32,
            device=dev))
    if cfg.get_bool("loadAccs", False):
        stats, names = load_stats(cfg.get_str("accsFilename"), device=dev)
    else:
        stats, names = accumulate_stats_from_ndx(cfg, gmm, verbose)

    def matrix(suffix: str) -> torch.Tensor:
        return torch.as_tensor(read_matrix_file(matrix_out_path(
            cfg.get_str("totalVariabilityMatrix") + suffix, cfg)),
            dtype=torch.float32, device=dev)

    if mode == "exact":
        # ivSolver: "pcg" (default; eigendecomposition-preconditioned
        # conjugate gradients, exact to f32 roundoff) or "cholesky"
        w = estimate_w(stats, model,
                       chunk=cfg.get_int("speakerChunk", 256),
                       solver=cfg.get_str("ivSolver", "pcg"),
                       pcg_iters=cfg.get_int("ivSolverPcgIterations", 16),
                       pcg_tol=cfg.get_float("ivSolverPcgTolerance", 1e-7))
    elif mode == "ubmWeight":
        w = estimate_w_ubm_weight(stats, model, matrix("_weightedCov"))
    else:
        w = estimate_w_eigen_decomposition(stats, model, matrix("_EigDec_D"),
                                           matrix("_EigDec_Q"))
    w = w.cpu().numpy().astype(np.float64)
    out: dict[str, np.ndarray] = {}
    for i, name in enumerate(names):
        write_matrix_file(vector_path(name, cfg), w[i][None, :])
        out[name] = w[i]
        if verbose:
            print(f"i-vector [{name}] → {vector_path(name, cfg)}")
    if cfg.exists("ivectorsOutput"):
        np.savez(cfg.get_str("ivectorsOutput"), w=w,
                 names=np.asarray(names, dtype=object))
    return out


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
