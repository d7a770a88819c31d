"""ComputeTest: GMM-UBM LLR trial scoring CLI (port of
lia_ral_tpu/tools/compute_test.py).

Equivalent of reference ``LIA_SpkDet/ComputeTest`` (ComputeTestMain.cpp:
137-165), selected with ``computeTestMode``:

* plain (ComputeTest.cpp:90-224): per NDX line (test file × targets),
  top-K LLR scoring with worldDecime decimation, NIST output; with
  ``segmentLLR`` one LLR per segment, with ``windowLLR`` one per sliding
  window of frames;
* jfa (cpp:376) / lfa (cpp:574): the test session's channel factor is
  estimated on its stats, world and clients are shifted by U·x, then
  top-K LLR;
* byLabel (cpp:916): one score per label cluster of the test file;
* histo (cpp:1031): per-frame LLR histogram → entropy or robust mean;
* dotProduct (cpp:228): <Σ⁻¹·(sv_client − sv_world), F̄_test>/frames,
  optional NAP (``napMatrix``) of the client offset;
* nap (cpp:767): NAP of the client mean supervectors, then top-K LLR.

In both supervector modes the test stats are the plain
``accumulate_bw_stats`` (as in the JAX package), not kernel K2.

Plain-mode lines with the same client set and frame bucket score as one
batch (``compute_test_llr_batch``); each result carries its NDX line
index, so the output keeps the NDX line order.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..backend.supervector import (compute_nap, model_to_sv,
                                   project_on_subspace)
from ..backend.unsupervised import windowed_llr
from ..config import Config
from ..fa.jfa import JfaModel
from ..fa.lfa import (channel_gram, compensate_model, estimate_channel,
                      lfa_model)
from ..fa.stats import BwStats, accumulate_bw_stats
from ..gmm.model import GmmDiag
from ..gmm.scoring import (compute_test_llr, compute_test_llr_batch,
                           decime_groups, stack_gmms, top_k_llk)
from ..io.features import server_from_config
from ..io.labels import (SegmentStore, frame_idx_to_time,
                         frame_mask_to_segments)
from ..io.lists import read_ndx
from ..io.matrix import read_matrix_file
from ..io.nist import ScoreLine, read_nist_scores, write_nist_scores
from ..utils.shapes import FRAME_BUCKET, bucket_len, next_pow2
from .common import (label_path, load_features_and_mask, mixture_path,
                     resolve_device, setup_verbose)
from .total_variability import matrix_out_path


def _pad_frames(x: np.ndarray, w: np.ndarray | None = None,
                groups: np.ndarray | None = None,
                bucket: int = FRAME_BUCKET):
    """Zero-weight pad the frame axis to a bucket multiple, so lines of
    different lengths share a batch.  Exact: every consumer weights
    frames by w; padded frames determine their own top-K sets and carry
    zero weight."""
    t = x.shape[0]
    p = bucket_len(t, bucket)
    if w is None:
        w = np.ones(t, np.float32)
    if p == t:
        g = np.arange(t, dtype=np.int32) if groups is None else groups
        return x, w, g
    xp = np.zeros((p,) + x.shape[1:], np.float32)
    xp[:t] = x
    wp = np.zeros(p, np.float32)
    wp[:t] = w
    gp = np.arange(p, dtype=np.int32)
    if groups is not None:
        gp[:t] = groups
    return xp, wp, gp


def _pad_clients(clients: list) -> tuple[list, int]:
    """Pad the client list to the next power of two, as the JAX package
    does (padded rows repeat client 0; the caller drops their scores).
    Returns (clients, real count)."""
    c = len(clients)
    c_pad = next_pow2(c) if c else 1
    return clients + [clients[0]] * (c_pad - c), c


def _histo_score(llr_series: np.ndarray, score_type: str,
                 nb_bins: int) -> float:
    """ComputeTestHisto scoring (cpp:1031+): entropy of the per-frame LLR
    histogram, or a histogram-trimmed robust mean."""
    hist, edges = np.histogram(llr_series, bins=nb_bins, density=True)
    widths = np.diff(edges)
    if score_type == "entropy":
        p = hist * widths
        p = p[p > 0]
        return float(-np.sum(p * np.log(p)))
    # robust mean: average over the central 90% of the distribution
    lo, hi = np.percentile(llr_series, [5, 95])
    sel = (llr_series >= lo) & (llr_series <= hi)
    return float(llr_series[sel].mean()) if sel.any() \
        else float(llr_series.mean())


def _line_batch_cap(c_pad: int, plen: int, k_world: int) -> int:
    """Lines per batched call: the scorer holds a (B, P, C, K) f32 density
    block, so B is bounded to keep it near 2 GB (a power of two, at most
    16)."""
    per_line = max(c_pad * plen * k_world * 4, 1)
    cap = max(1, min(16, (2 << 30) // per_line))
    return 1 << (cap.bit_length() - 1)              # round down to pow2


def _decision(score: float, threshold: float) -> str:
    return "1" if score > threshold else "0"


def _flush_plain_group(key, rows, group_clients, world, top_k, gender,
                       threshold, ordered) -> None:
    """Score one (client set, frame bucket) group of plain-mode NDX lines
    in one batch, keeping each line's NDX index for the output order."""
    mnames, _plen = key
    clients, c_real = _pad_clients(group_clients[key])
    dev = world.device
    xb, wb, gb = (torch.from_numpy(np.stack([r[i] for r in rows])).to(dev)
                  for i in (2, 3, 4))
    llr = compute_test_llr_batch(xb, wb, world, stack_gmms(clients), gb,
                                 top_k=top_k).cpu().numpy()
    for j, (ln, test_name, *_rest) in enumerate(rows):
        for i, mn in enumerate(mnames[:c_real]):
            ordered.append((ln, ScoreLine(gender, mn,
                                          _decision(llr[j, i], threshold),
                                          test_name, float(llr[j, i]))))


def main(cfg: Config) -> list[ScoreLine]:
    mode = cfg.get_str("computeTestMode", "plain")
    if mode == "dotProduct":
        return dot_product_main(cfg)
    if mode == "nap":
        return nap_main(cfg)
    if mode in ("jfa", "lfa"):
        return channel_comp_main(cfg, lfa=(mode == "lfa"))
    if mode == "byLabel":
        return by_label_main(cfg)
    if mode == "histo":
        return histo_main(cfg)
    verbose = setup_verbose(cfg)
    # rerun-a-failed-shard recovery (the reference's fexist guard,
    # ComputeTest.cpp:82-86): with ``skipExistingOutput`` an existing
    # non-empty score file short-circuits the run
    out_path = cfg.get_str("outputFilename")
    if (cfg.get_bool("skipExistingOutput", False)
            and os.path.exists(out_path) and os.path.getsize(out_path) > 0):
        print(f"output [{out_path}] exists — skipping (skipExistingOutput)")
        return read_nist_scores(out_path)
    world, ndx, gender, threshold, top_k = _trial_context(cfg)
    dev = world.device
    world_decime = cfg.get_int("worldDecime", 1)
    # both spellings: bool key ``segmentLLR`` (ComputeTest.cpp:98) and
    # ``segmentalMode segmentLLR`` (cpp:774)
    segmental = (cfg.get_bool("segmentLLR", False)
                 or cfg.get_str("segmentalMode", "") == "segmentLLR")
    window_llr = cfg.get_bool("windowLLR", False)
    frame_length = cfg.get_float("frameLength", 0.01)
    # maxTargetLine caps clients per NDX line (ComputeTest.cpp:107);
    # nbMaxMixtureInMemory bounds the client-model cache (cpp:212-216)
    max_clients = cfg.get_int("maxTargetLine", 100)
    max_cached = cfg.get_int("nbMaxMixtureInMemory", 0)
    results: list[ScoreLine] = []
    ordered: list[tuple[int, ScoreLine]] = []
    pending: dict[tuple, list] = {}
    group_clients: dict[tuple, list] = {}
    model_cache: dict[str, GmmDiag] = {}
    for line_no, (test_name, model_names) in enumerate(ndx):
        model_names = model_names[:max_clients]
        # per-line failure containment: the reference catches
        # alize::Exception per NDX line, warns, and moves on
        try:
            fs, mask = load_features_and_mask([test_name], cfg)
        except Exception as e:
            print(f"WARNING: cannot read test segment [{test_name}]: {e}"
                  " — line skipped")
            continue
        if mask.sum() == 0:
            print(f"ATTENTION, TEST FILE [{test_name}] is empty")
            continue
        clients, kept = [], []
        for mn in model_names:
            if mn not in model_cache:
                if max_cached and len(model_cache) >= max_cached:
                    model_cache.clear()
                try:
                    model_cache[mn] = GmmDiag.load(mixture_path(mn, cfg),
                                                   device=dev)
                except Exception as e:
                    print(f"WARNING: cannot load model [{mn}]: {e}"
                          " — model skipped")
                    continue
            clients.append(model_cache[mn])
            kept.append(mn)
        model_names = kept
        if not clients:
            continue
        clients, c_real = _pad_clients(clients)
        segs = frame_mask_to_segments(mask > 0, frame_length)
        sel = np.nonzero(mask > 0)[0]
        t_real = sel.shape[0]
        seg_lengths = [s.frames(frame_length)[1] - s.frames(frame_length)[0]
                       for s in segs]
        x_np, w_np, g_np = _pad_frames(
            fs.data[sel], groups=decime_groups(seg_lengths, world_decime))
        if segmental or window_llr:
            world_llk, client_llk = top_k_llk(
                torch.from_numpy(x_np).to(dev), world, stack_gmms(clients),
                torch.from_numpy(g_np).to(dev), top_k=top_k)
            world_llk = world_llk.cpu().numpy()
            client_llk = client_llk.cpu().numpy()
        if window_llr:
            # windowed LLR (reference WindowLLR, ComputeTest.cpp:168-192):
            # one score per sliding window of frames
            window = cfg.get_int("windowLLRSize", 100)
            step = cfg.get_int("windowLLRDec", window)
            llr_series = (client_llk[:c_real, :t_real]
                          - world_llk[None, :t_real])
            for i, mn in enumerate(model_names):
                starts, means = windowed_llr(llr_series[i], window, step)
                for st_, sc in zip(starts, means):
                    results.append(ScoreLine(
                        gender, mn, _decision(sc, threshold), test_name,
                        float(sc), begin=float(st_) * frame_length,
                        end=float(st_ + window) * frame_length))
            continue
        if segmental:
            off = 0
            for s, n in zip(segs, seg_lengths):
                a = s.frames(frame_length)[0]
                wl = float(np.mean(world_llk[off:off + n]))
                for i, mn in enumerate(model_names):
                    llr = float(np.mean(client_llk[i, off:off + n])) - wl
                    # times per reference: [frameIdxToTime(begin),
                    # frameIdxToTime(begin+length)] (ComputeTest.cpp:187)
                    results.append(ScoreLine(
                        gender, mn, _decision(llr, threshold), test_name,
                        llr, begin=frame_idx_to_time(a, frame_length),
                        end=frame_idx_to_time(a + n, frame_length)))
                off += n
        else:
            key = (tuple(model_names), x_np.shape[0])
            if key not in pending:
                # keep the client models now: nbMaxMixtureInMemory may
                # clear model_cache before the deferred flush
                group_clients[key] = clients[:c_real]
            rows = pending.setdefault(key, [])
            rows.append((line_no, test_name, x_np, w_np, g_np))
            # flush at the memory-bounded batch size, so host memory stays
            # O(one batch), not O(trial list)
            if len(rows) >= _line_batch_cap(len(clients), x_np.shape[0],
                                            world.n_components):
                _flush_plain_group(key, rows, group_clients, world, top_k,
                                   gender, threshold, ordered)
                pending[key] = []
        if verbose:
            print(f"test seg[{test_name}] scored vs {model_names}")

    for key, rows in pending.items():
        if rows:
            _flush_plain_group(key, rows, group_clients, world, top_k,
                               gender, threshold, ordered)
    results.extend(sl for _, sl in sorted(ordered, key=lambda t: t[0]))
    write_nist_scores(out_path, results)
    return results


def _trial_context(cfg: Config):
    """World model (on the config's device), NDX and output keys."""
    world = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                         device=resolve_device(cfg))
    return (world, read_ndx(cfg.get_str("ndxFilename")),
            cfg.get_str("gender", "M"), cfg.get_float("decisionThreshold", 0.0),
            cfg.get_int("topDistribsCount", 10))


def _load_clients(model_names: list[str], cfg: Config, cache: dict,
                  device) -> list[GmmDiag]:
    for mn in model_names:
        if mn not in cache:
            cache[mn] = GmmDiag.load(mixture_path(mn, cfg), device=device)
    return [cache[mn] for mn in model_names]


def _load_jfa_model(cfg: Config, gmm: GmmDiag, lfa: bool) -> JfaModel:
    """The channel-compensation model from the matrix files: U
    (``eigenChannelMatrix``, default EC), and for LFA D from the relevance
    factor, for JFA V (``eigenVoiceMatrix``) when the config names it."""
    k, d = gmm.means.shape

    def subspace(name: str) -> torch.Tensor:
        mat = read_matrix_file(matrix_out_path(name, cfg))
        return torch.as_tensor(mat.reshape(mat.shape[0], k, d),
                               dtype=torch.float32, device=gmm.device)

    u = subspace(cfg.get_str("eigenChannelMatrix", "EC"))
    if lfa:
        return lfa_model(u, gmm, tau=cfg.get_float("regulationFactor", 16.0))
    v = (subspace(cfg.get_str("eigenVoiceMatrix"))
         if cfg.exists("eigenVoiceMatrix")
         else torch.zeros((1, k, d), device=gmm.device))
    return JfaModel(v=v, u=u, d=torch.zeros((k, d), device=gmm.device),
                    ubm_means=gmm.means.to(torch.float32),
                    ubm_inv_var=gmm.cov_inv.to(torch.float32))


def channel_comp_main(cfg: Config, lfa: bool) -> list[ScoreLine]:
    """JFA/LFA channel-compensated GMM scoring (ComputeTestJFA cpp:376,
    ComputeTestLFA cpp:574): estimate the test session's channel factor
    (no speaker prior: y = z = 0), shift world and clients by U·x, then
    plain top-K LLR.  The U Gram block is built once for the run."""
    world, ndx, gender, threshold, top_k = _trial_context(cfg)
    dev = world.device
    model = _load_jfa_model(cfg, world, lfa)
    gram = channel_gram(model)
    results = []
    cache: dict[str, GmmDiag] = {}
    for test_name, model_names in ndx:
        fs, mask = load_features_and_mask([test_name], cfg)
        x_np, w_np, _ = _pad_frames(np.asarray(fs.data, np.float32),
                                    w=np.asarray(mask, np.float32))
        x = torch.from_numpy(x_np).to(dev)
        w = torch.from_numpy(w_np).to(dev)
        n, f = accumulate_bw_stats(x, w, world)
        x_h = estimate_channel(BwStats(n=n[None], f=f[None]), model,
                               gram=gram)[0]
        clients, _ = _pad_clients(
            [compensate_model(c, model, x_h)
             for c in _load_clients(model_names, cfg, cache, dev)])
        llr = compute_test_llr(
            x, w, compensate_model(world, model, x_h), stack_gmms(clients),
            top_k=min(top_k, world.n_components))
        for mn, sc in zip(model_names, llr.cpu().numpy()):
            results.append(ScoreLine(gender, mn, _decision(sc, threshold),
                                     test_name, float(sc)))
    write_nist_scores(cfg.get_str("outputFilename"), results)
    return results


def dot_product_main(cfg: Config) -> list[ScoreLine]:
    """Supervector dot-product scoring (ComputeTestDotProduct, cpp:228):
    score = <Σ⁻¹·(sv_client − sv_world), F̄_test>/n_frames, optional NAP
    (``napMatrix``) on the client offset."""
    world, ndx, gender, threshold, _ = _trial_context(cfg)
    dev = world.device
    nap_u = None
    if cfg.exists("napMatrix"):
        nap_u = torch.as_tensor(read_matrix_file(cfg.get_str("napMatrix")),
                                dtype=torch.float32, device=dev)
    world_sv = model_to_sv(world)
    results = []
    offsets: dict[str, torch.Tensor] = {}
    for test_name, model_names in ndx:
        fs, mask = load_features_and_mask([test_name], cfg)
        x_np, w_np, _ = _pad_frames(np.asarray(fs.data, np.float32),
                                    w=np.asarray(mask, np.float32))
        n, f = accumulate_bw_stats(torch.from_numpy(x_np).to(dev),
                                   torch.from_numpy(w_np).to(dev), world)
        fbar = ((f - n[:, None] * world.means) * world.cov_inv).reshape(-1)
        frames = max(float(torch.sum(n)), 1e-6)
        for mn in model_names:
            if mn not in offsets:
                off = model_to_sv(GmmDiag.load(mixture_path(mn, cfg),
                                               device=dev)) - world_sv
                if nap_u is not None:
                    off = off - project_on_subspace(off[None, :], nap_u)[0]
                offsets[mn] = off
        scores = (torch.stack([offsets[mn] for mn in model_names]) @ fbar
                  ).cpu().numpy()
        for mn, sc in zip(model_names, scores):
            sc = float(sc) / frames
            results.append(ScoreLine(gender, mn, _decision(sc, threshold),
                                     test_name, sc))
    write_nist_scores(cfg.get_str("outputFilename"), results)
    return results


def nap_main(cfg: Config) -> list[ScoreLine]:
    """NAP-compensated GMM scoring (ComputeTestNAP, cpp:767): the
    nuisance subspace (``napMatrix``) projected out of the client mean
    supervectors, then top-K LLR on the selected frames."""
    world, ndx, gender, threshold, top_k = _trial_context(cfg)
    dev = world.device
    u = torch.as_tensor(read_matrix_file(cfg.get_str("napMatrix")),
                        dtype=torch.float32, device=dev)
    results = []
    cache: dict[str, GmmDiag] = {}
    for test_name, model_names in ndx:
        fs, mask = load_features_and_mask([test_name], cfg)
        sel = np.nonzero(mask > 0)[0]
        x_np, w_np, _ = _pad_frames(np.asarray(fs.data[sel], np.float32))
        for mn in model_names:
            if mn not in cache:
                cache[mn] = compute_nap(GmmDiag.load(mixture_path(mn, cfg),
                                                     device=dev), u)
        clients, _ = _pad_clients([cache[mn] for mn in model_names])
        llr = compute_test_llr(
            torch.from_numpy(x_np).to(dev), torch.from_numpy(w_np).to(dev),
            world, stack_gmms(clients), top_k=min(top_k, world.n_components))
        for mn, sc in zip(model_names, llr.cpu().numpy()):
            results.append(ScoreLine(gender, mn, _decision(sc, threshold),
                                     test_name, float(sc)))
    write_nist_scores(cfg.get_str("outputFilename"), results)
    return results


def by_label_main(cfg: Config) -> list[ScoreLine]:
    """Per-label scoring (ComputeTestByLabel, cpp:916): one LLR per label
    cluster of the test file."""
    world, ndx, gender, threshold, top_k = _trial_context(cfg)
    dev = world.device
    frame_length = cfg.get_float("frameLength", 0.01)
    results = []
    cache: dict[str, GmmDiag] = {}
    for test_name, model_names in ndx:
        fs = server_from_config([test_name], cfg)
        lp = label_path(test_name, cfg)
        store = SegmentStore.from_label_file(
            lp if os.path.isfile(lp) else None, fs.nframes, frame_length,
            add_default_label=True,
            default_label=cfg.get_str("defaultLabel", "speech"))
        clients, _ = _pad_clients(_load_clients(model_names, cfg, cache, dev))
        stacked = stack_gmms(clients)
        for label in store.labels():
            mask = store.mask(label, fs.nframes)
            if not mask.any():
                continue
            x_np, w_np, _ = _pad_frames(
                np.asarray(fs.data[np.nonzero(mask)[0]], np.float32))
            llr = compute_test_llr(
                torch.from_numpy(x_np).to(dev), torch.from_numpy(w_np).to(dev),
                world, stacked, top_k=min(top_k, world.n_components))
            for mn, sc in zip(model_names, llr.cpu().numpy()):
                results.append(ScoreLine(gender, mn,
                                         _decision(sc, threshold),
                                         f"{test_name}.{label}", float(sc)))
    write_nist_scores(cfg.get_str("outputFilename"), results)
    return results


def histo_main(cfg: Config) -> list[ScoreLine]:
    """Histogram scoring (ComputeTestHisto, cpp:1031): per-frame LLR
    series → entropy or robust mean."""
    world, ndx, gender, threshold, top_k = _trial_context(cfg)
    dev = world.device
    nb_bins = cfg.get_int("nbBins", 30)
    score_type = cfg.get_str("scoreType", "entropy")
    results = []
    cache: dict[str, GmmDiag] = {}
    for test_name, model_names in ndx:
        fs, mask = load_features_and_mask([test_name], cfg)
        sel = np.nonzero(mask > 0)[0]
        t_real = sel.shape[0]
        x_np, _, g_np = _pad_frames(np.asarray(fs.data[sel], np.float32))
        clients, c_real = _pad_clients(
            _load_clients(model_names, cfg, cache, dev))
        world_llk, client_llk = top_k_llk(
            torch.from_numpy(x_np).to(dev), world, stack_gmms(clients),
            torch.from_numpy(g_np).to(dev),
            top_k=min(top_k, world.n_components))
        llr_series = (client_llk.cpu().numpy()[:c_real, :t_real]
                      - world_llk.cpu().numpy()[None, :t_real])
        for i, mn in enumerate(model_names):
            sc = _histo_score(llr_series[i], score_type, nb_bins)
            results.append(ScoreLine(gender, mn, _decision(sc, threshold),
                                     test_name, sc))
    write_nist_scores(cfg.get_str("outputFilename"), results)
    return results


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
