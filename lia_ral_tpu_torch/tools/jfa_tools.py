"""JFA CLI tools: ComputeJFAStats, EigenVoice, EigenChannel,
EstimateDMatrix (port of lia_ral_tpu/tools/jfa_tools.py).

Equivalents of the reference binaries:
* ComputeJFAStats (ComputeJFAStats.cpp:71-105) — precompute & save N/F
  sufficient stats;
* EigenVoice (EigenVoice.cpp:71-163) — V-matrix EM;
* EigenChannel (EigenChannel.cpp:70-200) — U-matrix EM;
* EstimateDMatrix (EstimateDMatrix.cpp:105-212) — diagonal D estimation.

NDX convention: each line "speakerId file1 [file2 ...]"; every file is one
session of that speaker (reference JFATranslate bookkeeping).  On a CUDA
device the session stats run in kernel K2 (``fastStats`` takes its bf16
tier); with ``loadAccs`` a tool reads the checkpoint ComputeJFAStats wrote
and launches no kernel.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import Config
from ..fa.jfa import (JfaModel, JfaStats, estimate_x, estimate_y,
                      jfa_d_iteration, jfa_u_iteration, jfa_v_iteration,
                      orthonormalize_v, restore_accs, store_accs)
from ..fa.stats import bw_stats_bucketed, load_stats, save_stats
from ..gmm.model import GmmDiag
from ..io.lists import read_ndx
from ..io.matrix import read_matrix_file, write_matrix_file
from .common import (file_frame_mask, load_files_batch, mixture_path,
                     resolve_device, setup_verbose)
from .total_variability import matrix_out_path


def accumulate_session_stats(cfg: Config, gmm: GmmDiag, verbose=False
                             ) -> tuple[JfaStats, list[str], list[str]]:
    """Stats of every session of ``ndxFilename`` on the GMM's device,
    through length-bucketed batches.  Returns (stats, speaker names,
    session names); an unreadable session is skipped with a warning."""
    ndx = read_ndx(cfg.get_str("ndxFilename"))
    spk_names, flat, flat_spk = [], [], []
    for spk, files in ndx:
        if spk not in spk_names:
            spk_names.append(spk)
        sid = spk_names.index(spk)
        for f in (files if files else [spk]):
            flat.append(f)
            flat_spk.append(sid)
    mats = load_files_batch(flat, cfg)
    sess_names, sess_spk, entries = [], [], []
    for f, sid, x in zip(flat, flat_spk, mats):
        if x is None:
            print(f"WARNING: cannot read session [{f}] — session skipped")
            continue
        try:
            mask = file_frame_mask(f, x.shape[0], cfg)
        except Exception as e:   # malformed .lbl → warn-skip, rerun shard
            print(f"WARNING: bad label file for session [{f}]: {e}"
                  " — session skipped")
            continue
        entries.append((x, mask))
        sess_names.append(f)
        sess_spk.append(sid)
        if verbose:
            print(f"stats [{spk_names[sid]}/{f}]: {int(mask.sum())} frames")
    sess = bw_stats_bucketed(
        entries, gmm, bucket=cfg.get_int("statsBucketFrames", 2048),
        batch_size=cfg.get_int("statsBatchSize", 64),
        stats_pass="bf16nx" if cfg.get_bool("fastStats", False) else "x3")
    stats = JfaStats.from_sessions(sess, np.asarray(sess_spk),
                                   len(spk_names))
    return stats, spk_names, sess_names


def _save_accs(cfg: Config, stats: JfaStats, sess_names: list[str]) -> None:
    """The session stats as ``accsFilename`` (.npz) and the
    session→speaker index beside it."""
    save_stats(cfg.get_str("accsFilename"), stats.sess, sess_names)
    np.save(cfg.get_str("accsFilename") + ".spk.npy",
            stats.sess_spk.cpu().numpy().astype(np.int32))


def load_or_accumulate(cfg: Config, gmm: GmmDiag, verbose=False) -> JfaStats:
    if cfg.get_bool("loadAccs", False):
        sess, _ = load_stats(cfg.get_str("accsFilename"), device=gmm.device)
        sess_spk = np.load(cfg.get_str("accsFilename") + ".spk.npy")
        return JfaStats.from_sessions(sess, sess_spk,
                                      int(sess_spk.max()) + 1)
    stats, _, sess_names = accumulate_session_stats(cfg, gmm, verbose)
    if cfg.exists("accsFilename"):
        _save_accs(cfg, stats, sess_names)
    return stats


def load_subspace(cfg: Config, key: str, gmm: GmmDiag) -> torch.Tensor:
    """The (R, K·D) matrix file the config key names, as (R,K,D) on the
    GMM's device."""
    mat = read_matrix_file(matrix_out_path(cfg.get_str(key), cfg))
    k, d = gmm.means.shape
    return torch.as_tensor(mat.reshape(mat.shape[0], k, d),
                           dtype=torch.float32, device=gmm.device)


def _save_subspace(name: str, t: torch.Tensor, cfg: Config) -> None:
    write_matrix_file(matrix_out_path(name, cfg),
                      t.reshape(t.shape[0], -1).cpu().numpy()
                      .astype(np.float64))


def _setup(cfg: Config) -> tuple[bool, GmmDiag, JfaStats, torch.Generator]:
    verbose = setup_verbose(cfg)
    device = resolve_device(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                       device=device)
    gen = torch.Generator(device=device).manual_seed(
        cfg.get_int("randomSeed", 0))
    return verbose, gmm, load_or_accumulate(cfg, gmm, verbose), gen


def _zero_latents(stats: JfaStats, gmm: GmmDiag, rank_u: int):
    """x = 0 per session and z = 0 per speaker."""
    dev = gmm.device
    return (torch.zeros((stats.sess.n.shape[0], rank_u), device=dev),
            torch.zeros((stats.spk.n.shape[0],) + tuple(gmm.means.shape),
                        device=dev))


def compute_jfa_stats_main(cfg: Config) -> JfaStats:
    """ComputeJFAStats: accumulate and checkpoint N/F."""
    verbose = setup_verbose(cfg)
    gmm = GmmDiag.load(mixture_path(cfg.get_str("inputWorldFilename"), cfg),
                       device=resolve_device(cfg))
    stats, _, sess_names = accumulate_session_stats(cfg, gmm, verbose)
    _save_accs(cfg, stats, sess_names)
    return stats


def eigen_voice_main(cfg: Config) -> JfaModel:
    verbose, gmm, stats, gen = _setup(cfg)
    rank_v = cfg.get_int("eigenVoiceNumber")
    rank_u = cfg.get_int("eigenChannelNumber", 1)
    model = JfaModel.init(gen, rank_v, rank_u, gmm,
                          scale=cfg.get_float("initScale", 0.001))
    x, z = _zero_latents(stats, gmm, rank_u)
    # the reference snapshots the accumulators before each substep's
    # in-place mutations (storeAccs/restoreAccs, EigenVoice.cpp:117/150);
    # with immutable stats the pairing is a no-op kept for flow parity
    snapshot = store_accs(stats)
    ortho = cfg.get_bool("orthonormalizeV", False)   # EigenVoice.cpp:143
    for it in range(cfg.get_int("nbIt", 10)):
        model, _ = jfa_v_iteration(stats, model, x, z)
        if ortho:
            model = orthonormalize_v(model)
        stats = restore_accs(snapshot)
        if verbose:
            print(f"EigenVoice it {it}: |V|="
                  f"{float(model.v.abs().mean()):.6f}")
    _save_subspace(cfg.get_str("eigenVoiceMatrix", "EV"), model.v, cfg)
    return model


def eigen_channel_main(cfg: Config) -> JfaModel:
    verbose, gmm, stats, gen = _setup(cfg)
    rank_u = cfg.get_int("eigenChannelNumber")
    model = JfaModel.init(gen, 1, rank_u, gmm,
                          scale=cfg.get_float("initScale", 0.001))
    if cfg.exists("eigenVoiceMatrix"):
        model = model.replace(v=load_subspace(cfg, "eigenVoiceMatrix", gmm))
    x, z = _zero_latents(stats, gmm, rank_u)
    # reference EigenChannel: Y with V fixed, then the U substep
    for it in range(cfg.get_int("nbIt", 10)):
        y, _ = estimate_y(stats, model, x, z)
        model, x = jfa_u_iteration(stats, model, y, z)
        if verbose:
            print(f"EigenChannel it {it}: |U|="
                  f"{float(model.u.abs().mean()):.6f}")
    _save_subspace(cfg.get_str("eigenChannelMatrix", "EC"), model.u, cfg)
    return model


def estimate_d_matrix_main(cfg: Config) -> JfaModel:
    verbose, gmm, stats, gen = _setup(cfg)
    model = JfaModel.init(gen, 1, 1, gmm)
    if cfg.exists("eigenVoiceMatrix"):
        model = model.replace(v=load_subspace(cfg, "eigenVoiceMatrix", gmm))
    if cfg.exists("eigenChannelMatrix"):
        model = model.replace(u=load_subspace(cfg, "eigenChannelMatrix", gmm))
    tau = cfg.get_float("regulationFactor", 10.0)
    x, z = _zero_latents(stats, gmm, model.rank_u)
    for it in range(cfg.get_int("nbIt", 5)):
        y, _ = estimate_y(stats, model, x, z)
        x, _ = estimate_x(stats, model, y, z)
        model, z = jfa_d_iteration(stats, model, y, x, tau)
        if verbose:
            print(f"EstimateD it {it}: |D|="
                  f"{float(model.d.abs().mean()):.6f}")
    _save_subspace(cfg.get_str("DMatrix", "D"), model.d[None], cfg)
    return model


def main(cfg: Config):
    mode = cfg.get_str("jfaMode", "stats")
    return {"stats": compute_jfa_stats_main,
            "eigenVoice": eigen_voice_main,
            "eigenChannel": eigen_channel_main,
            "estimateD": estimate_d_matrix_main}[mode](cfg)


if __name__ == "__main__":
    main(Config.from_cli(sys.argv[1:]))
