"""NormFeat: feature normalisation CLI (port of
lia_ral_tpu/tools/norm_feat.py).

Equivalent of reference ``LIA_SpkDet/NormFeat`` modes (NormFeat.cpp):
``norm`` (cpp:231 — CMVN: file / segment / window with global fallback),
``featWarp`` (cpp:661), ``featMap`` (cpp:583) and ``info`` (cpp:520 —
print the stats) and ``featFA``/``featLFA`` (cpp:793/856: each file's
channel offset U·x, estimated on its own stats, removed from its
frames) and ``featNAP`` (cpp:724 — the occupancy-weighted NAP offset
of the world's supervector removed from every frame).  Normalised
features are written with the save format/extension keys.

Files are read ``FILE_BATCH`` at a time; in the file, window and warp
modes, files of one frame bucket go to the device as one zero-weight
padded (B, T, D) batch.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..backend.supervector import model_to_sv, project_on_subspace
from ..config import Config
from ..fa.lfa import channel_gram
from ..frontend.normfeat import (cmvn_global_batch, cmvn_segmental,
                                 cmvn_window_batch, feature_mapping,
                                 feature_warping, feature_warping_batch)
from ..gmm.kernels import llk_and_posteriors
from ..gmm.model import GmmDiag
from ..io.features import write_feature_file
from ..io.matrix import read_matrix_file
from ..utils.shapes import bucket_len
from .common import (compensate_session, file_frame_mask,
                     load_features_and_mask, load_files_batch,
                     load_lfa_model, mixture_path, resolve_device,
                     resolve_list, setup_verbose)

FILE_BATCH = 128                 # files read (and batched) at a time


def _out_path(name: str, cfg: Config) -> str:
    root = cfg.get_str("featureFilesPath", "./")
    ext = cfg.get_str("saveFeatureFileExtension", ".norm.prm")
    return os.path.join(root, name + ext)


def _batched_norm(entries, kernel, device, prepad=None):
    """Run ``kernel(x (B,T,D), w (B,T)) -> (B,T,D)`` over length-bucketed
    zero-weight-padded batches of ragged files; returns per-file numpy
    outputs in input order.  ``prepad(x, w, plen)`` builds a file's padded
    rows instead of plain zero padding."""
    outs: list = [None] * len(entries)
    by_len: dict[int, list[int]] = {}
    for i, (x, _) in enumerate(entries):
        by_len.setdefault(bucket_len(x.shape[0]), []).append(i)
    for plen, idxs in by_len.items():
        d = entries[idxs[0]][0].shape[1]
        if prepad is not None:
            mats = [prepad(*entries[i], plen) for i in idxs]
            xs = np.stack([m[0] for m in mats])
            ws = np.stack([m[1] for m in mats])
        else:
            xs = np.zeros((len(idxs), plen, d), np.float32)
            ws = np.zeros((len(idxs), plen), np.float32)
            for j, i in enumerate(idxs):
                x, m = entries[i]
                xs[j, :x.shape[0]] = x
                ws[j, :m.shape[0]] = m
        ys = kernel(torch.from_numpy(xs).to(device),
                    torch.from_numpy(ws).to(device)).cpu().numpy()
        for j, i in enumerate(idxs):
            outs[i] = ys[j, :entries[i][0].shape[0]]
    return outs


def _warp_prepad(window: int):
    """Host-side reflect padding (the layout ``feature_warping`` builds)
    plus zero padding to the bucket, so batched and per-file results are
    identical."""
    half = window // 2

    def pad(x: np.ndarray, w: np.ndarray, plen: int):
        n, d = x.shape
        xp = np.zeros((plen + 2 * half, d), np.float32)
        wp = np.zeros((plen + 2 * half,), np.float32)
        xp[:half] = x[:half][::-1]
        wp[:half] = w[:half][::-1]
        xp[half:half + n] = x
        wp[half:half + n] = w
        xp[half + n:half + n + half] = x[-half:][::-1]
        wp[half + n:half + n + half] = w[-half:][::-1]
        return xp, wp

    return pad


def main(cfg: Config) -> dict[str, np.ndarray]:
    verbose = setup_verbose(cfg)
    mode = cfg.get_str("mode", "norm")
    dev = resolve_device(cfg)
    names = resolve_list(cfg, "inputFeatureFilename"
                         if cfg.exists("inputFeatureFilename")
                         else "inputFeatureFileName")
    seg_mode = cfg.get_str("segmentalMode", "file")
    window = int(cfg.get_float("windowDuration", 3.0)
                 / cfg.get_float("frameLength", 0.01))
    mapping = None
    if mode == "featMap":
        mapping = (GmmDiag.load(mixture_path(cfg.get_str("channelMixture"),
                                             cfg), device=dev),
                   GmmDiag.load(mixture_path(
                       cfg.get_str("inputWorldFilename"), cfg), device=dev))
    elif mode in ("featFA", "featLFA"):
        # (world, channel model, its U Gram block), built once per run
        world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"),
                                          cfg), device=dev)
        fa_model = load_lfa_model(cfg, world)
        mapping = (world, fa_model, channel_gram(fa_model))
    elif mode == "featNAP":
        # (world, its supervector's NAP component as (K, D)), once per run
        # (getUbmOffset, NormFeat.cpp:189-197)
        world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"),
                                          cfg), device=dev)
        u = torch.as_tensor(read_matrix_file(cfg.get_str("initChannelMatrix")),
                            dtype=torch.float32, device=dev)
        mapping = (world, project_on_subspace(model_to_sv(world), u)
                   .reshape(world.means.shape))
    out: dict[str, np.ndarray] = {}
    # FILE_BATCH files at a time: read, normalise, write and free, so a
    # corpus-size run keeps one chunk's inputs in memory
    for c0 in range(0, len(names), FILE_BATCH):
        _process_chunk(names[c0:c0 + FILE_BATCH], cfg, mode, seg_mode, window,
                       mapping, dev, verbose, out)
    return out


def _process_chunk(names, cfg, mode, seg_mode, window, mapping, dev, verbose,
                   out):
    entries: list[tuple[np.ndarray, np.ndarray]] = []
    for name, x in zip(names, load_files_batch(names, cfg)):
        if x is None:
            # surface the real error through the strict single-file path
            fs, mask = load_features_and_mask([name], cfg)
            x = fs.data
        else:
            mask = file_frame_mask(name, x.shape[0], cfg)
        entries.append((np.asarray(x, np.float32),
                        np.asarray(mask, np.float32)))

    # batched paths (the common modes)
    batched: list[np.ndarray | None] | None = None
    wwin = window if window % 2 == 1 else window + 1
    if mode == "norm" and seg_mode == "file":
        cms_only = cfg.get_bool("cmsOnly", False)
        var_only = cfg.get_bool("varOnly", False)
        batched = _batched_norm(
            entries, lambda x, w: cmvn_global_batch(
                x, w, cms_only=cms_only, var_only=var_only), dev)
    elif mode == "norm" and seg_mode == "window":
        batched = _batched_norm(
            entries, lambda x, w: cmvn_window_batch(x, w, window), dev)
    elif mode == "featWarp":
        # files shorter than half a window keep the per-file path (their
        # reflect padding degenerates)
        big = [i for i, (x, _) in enumerate(entries)
               if x.shape[0] >= wwin // 2]
        batched = [None] * len(entries)
        if big:
            sub = _batched_norm(
                [entries[i] for i in big],
                lambda x, w: feature_warping_batch(x, w, wwin), dev,
                prepad=_warp_prepad(wwin))
            for j, i in enumerate(big):
                batched[i] = sub[j]

    for idx, name in enumerate(names):
        xn, mask = entries[idx]
        if mode == "info":
            mean = np.average(xn, axis=0, weights=mask)
            var = np.average((xn - mean) ** 2, axis=0, weights=mask)
            print(f"[{name}] mean={mean} var={var}")
            out[name] = np.stack([mean, var])
            continue
        if batched is not None and batched[idx] is not None:
            data = batched[idx]
        else:
            x = torch.tensor(xn, device=dev)    # a copy: xn is read-only
            w = torch.tensor(mask, device=dev)
            if mode == "norm" and seg_mode == "segment":
                # one segment id per contiguous selected run
                runs = np.cumsum(np.abs(np.diff(np.r_[0, mask > 0])))
                ids = np.maximum((runs - 1) // 2, 0).astype(np.int64)
                n_seg = int(ids.max()) + 1 if ids.size else 1
                y = cmvn_segmental(x, torch.from_numpy(ids), w, n_seg)
            elif mode == "featWarp":
                y = feature_warping(x, w, wwin)
            elif mode == "featMap":
                # onto a channel-independent root model (featMap,
                # NormFeat.cpp:583)
                y = feature_mapping(x, *mapping)
            elif mode in ("featFA", "featLFA"):
                # feature-domain channel compensation (reference
                # normFeatFA/normFeatLFA, NormFeat.cpp:793/856)
                y = compensate_session(x, w, *mapping)
            elif mode == "featNAP":
                # NAP feature-domain compensation (reference normFeatNAP,
                # NormFeat.cpp:724; featureChannelCompNAP cpp:213-229):
                # x_d −= Σ_k γ_k(x)·ubm_offset[k, d], one (N, K) @ (K, D)
                world, ubm_offset = mapping
                _, occ = llk_and_posteriors(x, world)
                y = x - occ @ ubm_offset
            else:
                raise ValueError(f"unknown NormFeat mode {mode}")
            data = y.cpu().numpy()
        keep = data if cfg.get_bool("writeAllFeatures", True) \
            else data[mask > 0]
        write_feature_file(_out_path(name, cfg), keep,
                           fmt=cfg.get_str("saveFeatureFileFormat", "SPRO4"))
        out[name] = keep
        if verbose:
            print(f"[{name}] mode={mode}/{seg_mode} → {_out_path(name, cfg)}")


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
