"""End-to-end JFA record of the PyTorch port (BASELINE.md config 4:
300 eigenvoices, 100 eigenchannels and D).

The counterpart of scripts/milestone_jfa.py for lia_ral_tpu_torch, which
imports torch, numpy and the port only.  It chains the port's CLI tools
over the JAX driver's synthetic corpus (``SCALES`` and ``gen_corpus``,
copied: the same draws in the same order), whose speaker offsets live in
a rank-rv voice subspace and whose per-session offsets live in a rank-ru
channel subspace, so a wrong U shows in the EER:

  ComputeJFAStats → EigenVoice (orthonormalizeV) → EigenChannel →
  EstimateDMatrix → TrainTarget (channelCompensation JFA) →
  ComputeTest (computeTestMode jfa) → EER/minDCF

on the card unless ``--device cpu``.  V and U start from numpy draws of
``--seed`` (torch_milestone_eer.numpy_inits), not from a torch
generator, so the card and the CPU start alike.

Usage: python scripts/torch_milestone_jfa.py [--scale small|full|full2048]
           [--noD] [--scoring jfa|dot] [--itv N] [--ndev N]
           [--device cuda|cpu] [--workdir D] [--seed N] [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from torch_milestone_eer import (Stages, check_device, common_args,
                                 device_line, emit, launches, numpy_inits,
                                 reset_launches, score_stats, warm_up)

SCALES = {
    # k: UBM comps, rv/ru: V/U ranks, spk/imp counts, sessions per dev spk
    "small": dict(k=64, d=24, rv=16, ru=8, n_dev=24, n_spk=10, n_imp=5,
                  sess=4, t_utt=600, it_v=6, it_u=6, it_d=3),
    # v_base/u_base: per-dim TOTAL shift std = 4*v_base (speaker) /
    # 2.83*u_base (channel) after rank normalisation in gen_corpus: a weak
    # speaker and a strong channel, 300-frame tests
    "full": dict(k=512, d=39, rv=300, ru=100, n_dev=500, n_spk=40, n_imp=10,
                 sess=4, t_utt=1200, it_v=10, it_u=8, it_d=4,
                 v_base=0.15, u_base=0.9, t_test=300),
    # the K=2048 UBM of the i-vector systems; utterance lengths scale with
    # K so that frames per component match the K=512 corpus
    "full2048": dict(k=2048, d=39, rv=300, ru=100, n_dev=500, n_spk=40,
                     n_imp=10, sess=4, t_utt=4800, it_v=10, it_u=8,
                     it_d=4, v_base=0.15, u_base=0.9, t_test=1200),
}


def gen_corpus(d, p, rng):
    """Speaker offsets in a rank-rv 'voice' subspace, session offsets in a
    rank-ru 'channel' subspace — the JFA generative model itself, sampled
    through a shared diagonal GMM (the JAX driver's, same draws in the
    same order).  Subspace scales are normalised by rank so that the
    total speaker / channel shift variance does not depend on it."""
    from lia_ral_tpu_torch.gmm.model import GmmDiag
    from lia_ral_tpu_torch.io.features import write_feature_file

    k, dim = p["k"], p["d"]
    w = rng.random(k) + 0.5
    w /= w.sum()
    means = rng.standard_normal((k, dim)) * 2.0
    cov = rng.random((k, dim)) * 0.5 + 0.8
    # the JAX driver passes these values as the inverse variances
    ubm = GmmDiag.create(w, means.astype(np.float32), cov.astype(np.float32))

    v_base = p.get("v_base", 0.6)
    u_base = p.get("u_base", 0.35)
    v_true = (rng.standard_normal((p["rv"], k, dim))
              * v_base * np.sqrt(16.0 / p["rv"]))
    u_true = (rng.standard_normal((p["ru"], k, dim))
              * u_base * np.sqrt(8.0 / p["ru"]))

    vy_cache: dict[int, np.ndarray] = {}

    def utt(y, n, spk_id=None):
        # V·y is per speaker: cached
        if spk_id is not None and spk_id in vy_cache:
            vy = vy_cache[spk_id]
        else:
            vy = np.einsum("r,rkd->kd", y, v_true)
            if spk_id is not None:
                vy_cache[spk_id] = vy
        x_h = rng.standard_normal(p["ru"])
        shift = vy + np.einsum("r,rkd->kd", x_h, u_true)
        comp = rng.choice(k, size=n, p=w)
        x = ((means + shift)[comp]
             + rng.standard_normal((n, dim)) * np.sqrt(cov)[comp])
        return x.astype(np.float32)

    n_all = p["n_dev"] + p["n_spk"] + p["n_imp"]
    ys = rng.standard_normal((n_all, p["rv"]))
    names = {"dev": [], "enroll": [], "test": []}
    for s in range(p["n_dev"]):
        for j in range(p["sess"]):
            nm = f"dev_s{s}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(ys[s], p["t_utt"], spk_id=s),
                               fmt="SPRO4")
            names["dev"].append((f"dev{s}", nm))
    for i in range(p["n_spk"] + p["n_imp"]):
        s = p["n_dev"] + i
        tag = f"model{i}" if i < p["n_spk"] else f"imp{i - p['n_spk']}"
        rows = []
        for j in range(2):                      # two enrollment sessions
            nm = f"enr_{tag}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(ys[s], p["t_utt"], spk_id=s),
                               fmt="SPRO4")
            rows.append(nm)
        names["enroll"].append((tag, rows))
        if i < p["n_spk"]:                      # two test sessions each
            for j in range(2):
                nm = f"test_s{i}_{j}"
                write_feature_file(os.path.join(d, nm + ".prm"),
                                   utt(ys[s], p.get("t_test", p["t_utt"] // 2),
                                       spk_id=s),
                                   fmt="SPRO4")
                names["test"].append((i, nm))
    return ubm, names


def _group(pairs):
    """[(spk, file)...] → [[spk, f1, f2, ...]] preserving order."""
    by: dict = {}
    for spk, nm in pairs:
        by.setdefault(spk, []).append(nm)
    return [[spk] + files for spk, files in by.items()]


def run(workdir: str, p: dict, device: str = "cuda", no_d: bool = False,
        scoring: str = "jfa", seed: int = 0, scale: str = "custom",
        label: str = "") -> dict:
    """The JFA chain on ``p``'s corpus under ``workdir``; returns the
    record.  ``label``: the options named in the record's title."""
    from lia_ral_tpu_torch.backend.eval import eer, min_dcf
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.io.lists import write_xlist
    from lia_ral_tpu_torch.tools import compute_test, jfa_tools, train_target

    dev = check_device(device)
    d = workdir
    os.makedirs(d, exist_ok=True)
    stage = Stages(dev)
    with stage("device_warmup"):
        warm_up(dev)
    reset_launches()
    with stage("gen_corpus"):
        ubm, names = gen_corpus(d, p, np.random.default_rng(20260821))
        ubm.save(os.path.join(d, "wld.gmm"))

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "matrixFilesPath": d + "/", "saveVectorFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "inputWorldFilename": "wld",
        "accsFilename": os.path.join(d, "jfa_accs.npz"),
        "torchDevice": dev.type,
    }

    def cfg(**extra):
        return Config(dict(base, **extra))

    dev_ndx = os.path.join(d, "dev.ndx")
    write_xlist(dev_ndx, _group(names["dev"]))
    with numpy_inits(seed):
        with stage("compute_jfa_stats"):
            jfa_tools.compute_jfa_stats_main(cfg(ndxFilename=dev_ndx))
        with stage("eigen_voice"):
            jfa_tools.eigen_voice_main(cfg(
                ndxFilename=dev_ndx, loadAccs="true",
                eigenVoiceNumber=p["rv"], eigenChannelNumber=p["ru"],
                nbIt=p["it_v"], orthonormalizeV="true",
                eigenVoiceMatrix="EV"))
        with stage("eigen_channel"):
            jfa_tools.eigen_channel_main(cfg(
                ndxFilename=dev_ndx, loadAccs="true",
                eigenChannelNumber=p["ru"], eigenVoiceMatrix="EV",
                nbIt=p["it_u"], eigenChannelMatrix="EC"))
        if not no_d:
            with stage("estimate_d"):
                jfa_tools.estimate_d_matrix_main(cfg(
                    ndxFilename=dev_ndx, loadAccs="true",
                    eigenVoiceMatrix="EV", eigenChannelMatrix="EC",
                    nbIt=p["it_d"], DMatrix="D"))

        with stage("train_target_jfa"):
            write_xlist(os.path.join(d, "targets.ndx"),
                        [[tag] + rows for tag, rows in names["enroll"]])
            train_target.main(cfg(
                targetIdList=os.path.join(d, "targets.ndx"),
                channelCompensation="JFA", eigenVoiceMatrix="EV",
                eigenChannelMatrix="EC",
                **({} if no_d else {"DMatrix": "D"})))

        tgt_models = [t for t, _ in names["enroll"]]
        test_segs = [nm for _, nm in names["test"]]
        with stage("compute_test_jfa"):
            write_xlist(os.path.join(d, "trials.ndx"),
                        [[t] + tgt_models for t in test_segs])
            mode = ({"computeTestMode": "dotProduct"} if scoring == "dot"
                    else {"computeTestMode": "jfa",
                          "eigenChannelMatrix": "EC",
                          "topDistribsCount": 10})
            lines = compute_test.main(cfg(
                ndxFilename=os.path.join(d, "trials.ndx"),
                outputFilename=os.path.join(d, "scores_jfa.nist"),
                gender="M", maxTargetLine=1000, **mode))

    tgt, imp = [], []
    for ln in lines:
        spk = int(ln.seg.split("_s")[1].split("_")[0])
        (tgt if ln.model == f"model{spk}" else imp).append(ln.score)
    tgt, imp = np.asarray(tgt), np.asarray(imp)
    return {
        "milestone": f"config 4 JFA end-to-end ({scale}{label})",
        "device": device_line(dev),
        "shapes": {"K": p["k"], "D": p["d"], "rank_v": p["rv"],
                   "rank_u": p["ru"], "n_dev_speakers": p["n_dev"],
                   "n_targets": p["n_spk"],
                   "n_trials": len(test_segs) * len(tgt_models)},
        "seed": seed,
        "results": {"jfa_eer": eer(tgt, imp), "jfa_mindcf": min_dcf(tgt, imp)},
        "score_stats": {"jfa": score_stats(tgt, imp)},
        "stage_wall_s": stage.walls,
        "total_wall_s": sum(stage.walls.values()),
        "launches": launches(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="small", choices=list(SCALES))
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--noD", action="store_true",
                    help="skip EstimateDMatrix; enrol with V·y only")
    ap.add_argument("--scoring", default="jfa", choices=["jfa", "dot"],
                    help="jfa = channel-compensated frame LLR "
                         "(ComputeTest.cpp:376); dot = supervector "
                         "dot-product (cpp:228)")
    ap.add_argument("--itv", type=int, default=None,
                    help="override V EM iterations")
    ap.add_argument("--ndev", type=int, default=None,
                    help="override dev speaker count")
    common_args(ap)
    args = ap.parse_args()
    check_device(args.device)
    p = dict(SCALES[args.scale])
    if args.itv is not None:
        p["it_v"] = args.itv
    if args.ndev is not None:
        p["n_dev"] = args.ndev
    label = ((", noD" if args.noD else "")
             + (f", scoring={args.scoring}" if args.scoring != "jfa" else "")
             + (f", itv={args.itv}" if args.itv else "")
             + (f", ndev={args.ndev}" if args.ndev else ""))
    emit(run(args.workdir or tempfile.mkdtemp(prefix="torch_milestone_jfa_"),
             p, args.device, args.noD, args.scoring, args.seed, args.scale,
             label), args.out)


if __name__ == "__main__":
    main()
