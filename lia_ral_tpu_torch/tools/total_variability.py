"""TotalVariability: T-matrix EM trainer CLI (port of
lia_ral_tpu/tools/total_variability.py).

Equivalent of reference ``LIA_SpkDet/TotalVariability``
(TotalVariability.cpp:71-248): accumulate (or load) Baum-Welch stats →
random T init → EM loop with optional minimum divergence → save T and
the mean estimate (and, with ``approximationMode``, the ubmWeight or
eigenDecomposition matrices IvExtractor's fast modes read).  On a CUDA
device the stats run in kernel K2 (``fastStats`` takes its bf16 tier).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import Config
from ..fa.stats import BwStats, bw_stats_bucketed, load_stats, save_stats
from ..fa.tv import (TvModel, approximate_tctc, eigen_decompose_w, init_t,
                     tv_em_iteration, verify_em_llk, weighted_cov)
from ..gmm.model import GmmDiag
from ..io.lists import read_ndx
from ..io.matrix import write_matrix_file
from .common import (file_frame_mask, load_features_and_mask,
                     load_files_batch, mixture_path, resolve_device,
                     setup_verbose)


def matrix_out_path(name: str, cfg: Config) -> str:
    root = cfg.get_str("matrixFilesPath", "./")
    ext = cfg.get_str("saveMatrixFilesExtension", ".matx")
    return os.path.join(root, name + ext)


def accumulate_stats_from_ndx(cfg: Config, gmm: GmmDiag,
                              verbose: bool = False
                              ) -> tuple[BwStats, list[str]]:
    """Per NDX line (session id + feature files): one stats row, on the
    GMM's device.  Sessions are length-bucketed (padded to a multiple of
    ``statsBucketFrames``) into (batch, T, D) ``bw_stats_batch`` calls.
    An unreadable session is skipped with a warning (the reference's
    recovery model, TrainTarget.cpp:141-150)."""
    ndx = read_ndx(cfg.get_str("ndxFilename"))
    bucket = max(cfg.get_int("statsBucketFrames", 2048), 1)
    batch_size = max(cfg.get_int("statsBatchSize", 64), 1)
    flat: list[str] = []
    spans: list[tuple[str, int, int]] = []
    for session, files in ndx:
        if not files:
            files = [session]
        spans.append((session, len(flat), len(flat) + len(files)))
        flat.extend(files)
    mats = load_files_batch(flat, cfg)
    entries: list[tuple[str, np.ndarray, np.ndarray]] = []
    for session, a, b in spans:
        xs = mats[a:b]
        if any(x is None for x in xs):
            print(f"WARNING: cannot read session [{session}]"
                  " — session skipped")
            continue
        try:
            masks = [file_frame_mask(nm, x.shape[0], cfg)
                     for nm, x in zip(flat[a:b], xs)]
        except Exception as e:   # malformed .lbl → warn-skip, rerun shard
            print(f"WARNING: bad label file for session [{session}]: {e}"
                  " — session skipped")
            continue
        x = xs[0] if len(xs) == 1 else np.concatenate(xs)
        mask = masks[0] if len(masks) == 1 else np.concatenate(masks)
        entries.append((session, x, mask))
        if verbose:
            print(f"stats [{session}]: {int(mask.sum())} frames")
    stats = bw_stats_bucketed(
        [(x, m) for _, x, m in entries], gmm, bucket=bucket,
        batch_size=batch_size,
        stats_pass="bf16nx" if cfg.get_bool("fastStats", False) else "x3")
    return stats, [name for name, _, _ in entries]


def verify_llk(cfg: Config, names: list[str], stats: BwStats,
               model: TvModel, gmm: GmmDiag) -> float:
    """EM-likelihood check (key ``computeLLK``): ``fa.tv.verify_em_llk``
    on the first N sessions' features, zero-padded to one length with
    their masks."""
    loaded = [load_features_and_mask([name], cfg)
              for name in names[:cfg.get_int("computeLLK", 1)]]
    if not loaded:
        return 0.0
    t = max(fs.data.shape[0] for fs, _ in loaded)
    x = np.zeros((len(loaded), t, gmm.dim), np.float32)
    mask = np.zeros((len(loaded), t), np.float32)
    for i, (fs, m) in enumerate(loaded):
        x[i, :fs.data.shape[0]] = fs.data
        mask[i, :m.shape[0]] = m
    return verify_em_llk(torch.as_tensor(x, device=gmm.device),
                         torch.as_tensor(mask, device=gmm.device), stats,
                         model, gmm, max_utts=len(loaded))


def main(cfg: Config) -> TvModel:
    verbose = setup_verbose(cfg)
    dev = resolve_device(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                       device=dev)
    rank = cfg.get_int("totalVariabilityNumber")
    nb_it = cfg.get_int("nbIt", 10)
    min_div = cfg.get_bool("minDivergence", True)
    if cfg.get_bool("loadAccs", False):
        stats, names = load_stats(cfg.get_str("accsFilename"), device=dev)
    else:
        stats, names = accumulate_stats_from_ndx(cfg, gmm, verbose)
        if cfg.exists("accsFilename"):
            save_stats(cfg.get_str("accsFilename"), stats, names)
    gen = torch.Generator(device=dev).manual_seed(cfg.get_int("randomSeed",
                                                              0))
    model = init_t(gen, rank, gmm, scale=cfg.get_float("initScale", 0.001))
    if cfg.get_bool("saveInitMatrix", False):
        model.save(matrix_out_path(
            cfg.get_str("totalVariabilityMatrix") + "_init", cfg))
    for it in range(nb_it):
        model, _ = tv_em_iteration(stats, model,
                                   chunk=cfg.get_int("speakerChunk", 64),
                                   min_div=min_div)
        if verbose:
            print(f"TV EM it {it}: |T|={float(model.t.abs().mean()):.5f}")
        if cfg.exists("computeLLK") and not cfg.get_bool("loadAccs", False):
            total = verify_llk(cfg, names, stats, model, gmm)
            print(f"*** (Verify LLK) it {it} Total LLK={total:.5f} ***")
    model.save(matrix_out_path(cfg.get_str("totalVariabilityMatrix"), cfg))
    if min_div:
        write_matrix_file(matrix_out_path(
            cfg.get_str("meanEstimate", "meanEstimate"), cfg),
            model.ubm_means.cpu().numpy().astype(np.float64).reshape(1, -1))
    if cfg.exists("approximationMode"):
        mode = cfg.get_str("approximationMode")
        base = cfg.get_str("totalVariabilityMatrix")
        w_mat = weighted_cov(model, gmm.weights)
        if mode == "ubmWeight":
            mats = {"_weightedCov": w_mat}
        elif mode == "eigenDecomposition":
            q = eigen_decompose_w(w_mat)
            mats = {"_EigDec_D": approximate_tctc(model, q), "_EigDec_Q": q}
        else:
            print(f"approximationMode [{mode}] unknown")
            mats = {}
        for suffix, mat in mats.items():
            write_matrix_file(matrix_out_path(base + suffix, cfg),
                              mat.cpu().numpy().astype(np.float64))
    return model


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
