"""End-to-end diarization record of the PyTorch port: the 4-stage
LIA_SpkSeg chain on a conversation with silence and music.

The counterpart of scripts/milestone_diar.py for lia_ral_tpu_torch, which
imports torch, numpy and the port only.  On the JAX driver's synthetic
5-minute, 3-speaker conversation (``gen_conversation``, copied: the same
draws in the same order) it runs the port's tools, on the card unless
``--device cpu``:

  0. TrainWorld: speech / silence / music event models (K=32) on
     bootstrap samples of each event (a stand-in for the reference's
     pretrained fixtures);
  1. AcousticSegmentation (SAD): Viterbi over the event models — scored
     as SAD frame error, miss and false alarm;
  2. TrainWorld: the conversation world (K=128) on the SAD speech;
     TurnDetection (GLR boundaries) — scored as boundary recall and
     precision at ±250 ms;
  3. Segmentation (E-HMM) on the SAD speech — full-timeline DER, so SAD
     misses and false alarms count;
  4. ReSegmentation — refined DER.

Plus the turn-driven chain: detected turns greedily clustered by
world-normalised mean LLK (bestFittingCluster semantics, Tools.cpp:736)
and handed to ReSegmentation as its initial segmentation.

Every TrainWorld starts from a numpy-made init (``init_gmm`` of
torch_milestone_eer, ``--seed``), so the card and the CPU start alike;
chip_smoke.py phase 9 trains from the same inits.

Usage: python scripts/torch_milestone_diar.py [--device cuda|cpu]
           [--workdir D] [--seed N] [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from torch_milestone_eer import (Stages, check_device, common_args,
                                 device_line, emit, init_gmm, launches,
                                 reset_launches, warm_up)

N_SPK = 3
MINUTES = 5.0
D_FEAT = 24
K_BED = 64
K_EVENT = 32
K_UBM = 128
FRAME = 0.01
TOL_FRAMES = 25                 # ±250 ms boundary tolerance


def gen_conversation(rng):
    """(features (N,D), ref ids: speaker 0..N_SPK-1, -1 silence,
    -2 music, bootstrap samples per acoustic event): speech turns
    separated by silence gaps with occasional music segments."""
    centers = rng.standard_normal((K_BED, D_FEAT)) * 2.0
    spk_w = rng.dirichlet(np.full(K_BED, 2.5), size=N_SPK)
    spk_off = rng.standard_normal((N_SPK, K_BED, D_FEAT)) * 0.35
    mus_centers = rng.standard_normal((8, D_FEAT)) * 2.5
    sil_mean = np.full(D_FEAT, -3.5)

    def speech(s, n):
        comp = rng.choice(K_BED, size=n, p=spk_w[s])
        return (centers[comp] + spk_off[s, comp]
                + rng.standard_normal((n, D_FEAT)) * 0.6)

    def silence(n):
        return sil_mean + rng.standard_normal((n, D_FEAT)) * 0.25

    def music(n):
        comp = rng.integers(0, 8, n)
        return mus_centers[comp] + rng.standard_normal((n, D_FEAT)) * 0.4

    frames, ref = [], []
    total = int(MINUTES * 60 / FRAME)
    cur = 0
    while cur < total:
        s = int(rng.integers(N_SPK))
        n = int(rng.uniform(2.0, 8.0) * 100)
        frames.append(speech(s, n))
        ref.extend([s] * n)
        cur += n
        roll = rng.random()
        if roll < 0.55:                       # silence gap
            n = int(rng.uniform(0.5, 2.0) * 100)
            frames.append(silence(n))
            ref.extend([-1] * n)
            cur += n
        elif roll < 0.70:                     # music interlude
            n = int(rng.uniform(2.0, 5.0) * 100)
            frames.append(music(n))
            ref.extend([-2] * n)
            cur += n
    x = np.concatenate(frames).astype(np.float32)
    ref = np.asarray(ref)
    boots = {
        "boot_speech": np.concatenate(
            [speech(s, 2000) for s in range(N_SPK)]).astype(np.float32),
        "boot_silence": silence(2000).astype(np.float32),
        "boot_music": music(3000).astype(np.float32),
    }
    return x, ref, boots


def segs_to_frames(segs, n, frame_length=FRAME):
    """Per-frame label ids (-1 where no segment) of a segment list."""
    out = np.full(n, -1, np.int64)
    names = {}
    for s in segs:
        b = int(round(s.begin / frame_length))
        e = min(int(round(s.end / frame_length)), n)
        if s.label not in names:
            names[s.label] = len(names)
        out[b:e] = names[s.label]
    return out


def boundary_pr(true_b, det_b, tol=TOL_FRAMES):
    """Recall/precision of detected boundaries at ±tol frames."""
    true_b, det_b = np.asarray(true_b), np.asarray(det_b)
    if len(true_b) == 0 or len(det_b) == 0:
        return 0.0, 0.0
    hit_t = np.array([np.min(np.abs(det_b - t)) <= tol for t in true_b])
    hit_d = np.array([np.min(np.abs(true_b - t)) <= tol for t in det_b])
    return float(hit_t.mean()), float(hit_d.mean())


def speakers_found(ref, hyp) -> int:
    """Reference speakers that the optimal one-to-one mapping gives a
    hypothesis speaker holding more than half of their frames."""
    from scipy.optimize import linear_sum_assignment

    both = (ref >= 0) & (hyp >= 0)
    r_ids, h_ids = np.unique(ref[both]), np.unique(hyp[both])
    conf = np.zeros((len(r_ids), len(h_ids)), np.int64)
    np.add.at(conf, (np.searchsorted(r_ids, ref[both]),
                     np.searchsorted(h_ids, hyp[both])), 1)
    ri, hi = linear_sum_assignment(-conf)
    return int(sum(conf[r, h] > 0.5 * (ref == r_ids[r]).sum()
                   for r, h in zip(ri, hi)))


def run(workdir: str, device: str = "cuda", seed: int = 0) -> dict:
    """The chain on the conversation under ``workdir``; returns the
    record."""
    from lia_ral_tpu_torch.backend.eval import der
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.gmm.map_adapt import MapCfg, adapt_model
    from lia_ral_tpu_torch.gmm.model import GmmDiag
    from lia_ral_tpu_torch.io.features import write_feature_file
    from lia_ral_tpu_torch.io.labels import Segment, write_label_file
    from lia_ral_tpu_torch.seg.clustering import segment_mean_llk
    from lia_ral_tpu_torch.tools import train_world
    from lia_ral_tpu_torch.tools.spkseg_tools import (acoustic_main,
                                                      reseg_main,
                                                      segmentation_main,
                                                      turn_detection_main)

    dev = check_device(device)
    d = workdir
    os.makedirs(d, exist_ok=True)
    stage = Stages(dev)
    with stage("device_warmup"):
        warm_up(dev, libraries=("gmm_stats", "viterbi"))
    reset_launches()
    with stage("gen_corpus"):
        x, ref, boots = gen_conversation(np.random.default_rng(20260823))
        write_feature_file(os.path.join(d, "conv.prm"), x, fmt="SPRO4")
        for nm, bx in boots.items():
            write_feature_file(os.path.join(d, nm + ".prm"), bx,
                               fmt="SPRO4")

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "nbTrainIt": 4, "baggedFrameProbability": 1.0,
        "baggedFrameProbabilityInit": 1.0,
        "initVarianceFlooring": 1.0, "initVarianceCeiling": 10.0,
        "finalVarianceFlooring": 0.5, "finalVarianceCeiling": 5.0,
        "torchDevice": dev.type,
    }

    def cfg(**extra):
        return Config(dict(base, **extra))

    def train(frames, k, data, out):
        init_gmm(frames, k, seed).save(os.path.join(d, f"init_{out}.gmm"))
        train_world.main(cfg(mixtureDistribCount=k,
                             inputFeatureFilename=data,
                             inputWorldFilename=f"init_{out}",
                             outputWorldFilename=out))

    # ---- stage 0: acoustic event models (one K for all events: the
    # decoder stacks the state models into one bank) -------------------
    with stage("train_acoustic_models"):
        for nm in ("boot_speech", "boot_silence", "boot_music"):
            train(boots[nm], K_EVENT, nm, nm.replace("boot_", "evt_"))

    # ---- stage 1: AcousticSegmentation (SAD) --------------------------
    with stage("acoustic_segmentation"):
        ev_segs = acoustic_main(cfg(
            inputFeatureFilename="conv",
            acousticModels="evt_speech,evt_silence,evt_music",
            saveLabelFileExtension=".sad.lbl", minimumDuration=30))["conv"]

    n = ref.shape[0]
    sad = np.zeros(n, bool)
    for s in ev_segs:
        if s.label == "evt_speech":
            sad[int(round(s.begin / FRAME)):
                min(int(round(s.end / FRAME)), n)] = True
    ref_speech = ref >= 0
    res = {
        "n_frames": int(n),
        "speech_frac_ref": float(ref_speech.mean()),
        "sad_frame_err": float((sad != ref_speech).mean()),
        "sad_miss": float((ref_speech & ~sad).sum()
                          / max(ref_speech.sum(), 1)),
        "sad_fa": float((~ref_speech & sad).sum()
                        / max((~ref_speech).sum(), 1)),
    }

    # the speech-only timeline for the later stages (the reference selects
    # the SAD label before Segmentation: labelSelectedFrames)
    sp_idx = np.nonzero(sad)[0]
    x_sp = x[sp_idx]
    write_feature_file(os.path.join(d, "convsp.prm"), x_sp, fmt="SPRO4")
    ref_sp = ref[sp_idx]

    # the conversation world on the SAD speech frames (createWorld under
    # labelSelectedFrames=speech, Tools.cpp:1243)
    with stage("train_world"):
        train(x_sp, K_UBM, "convsp", "wld")

    # ---- stage 2: TurnDetection on the SAD speech ---------------------
    with stage("turn_detection"):
        turn_segs = turn_detection_main(cfg(
            inputFeatureFilename="convsp", saveLabelFileExtension=".turn.lbl",
            windowDuration=1.0, alpha=0.7))["convsp"]

    det_b = [int(round(s.begin / FRAME)) for s in turn_segs[1:]]
    # true boundaries on the speech timeline: speaker changes, plus
    # splice points where SAD removed a gap between different speakers
    chg = np.nonzero(np.diff(ref_sp) != 0)[0] + 1
    rec, prec = boundary_pr(chg, det_b)
    res.update({"n_turns_detected": len(det_b),
                "n_true_boundaries": int(len(chg)),
                "turn_recall_250ms": rec, "turn_precision_250ms": prec})

    def full_timeline(hyp_sp):
        hyp = np.full(n, -1, np.int64)
        hyp[sp_idx] = hyp_sp
        return hyp

    def score(tag, segs):
        hyp = full_timeline(segs_to_frames(segs, len(sp_idx)))
        res[f"n_hyp_speakers_{tag}"] = int(len({s.label for s in segs}))
        res[f"speakers_found_{tag}"] = speakers_found(ref, hyp)
        return hyp

    # ---- stage 3: Segmentation (E-HMM) on the SAD speech --------------
    with stage("segmentation"):
        segs = segmentation_main(cfg(
            mixtureDistribCount=K_UBM, inputFeatureFilename="convsp",
            inputWorldFilename="wld", maxSpeakers=5,
            MAPRegFactorMean=3.0,           # weak prior: new speakers win
            saveLabelFileExtension=".seg.lbl"))["convsp"]
    hyp_seg = score("seg", segs)
    res["der_segmentation"] = der(ref, hyp_seg)
    res["der_segmentation_collar25"] = der(ref, hyp_seg,
                                           collar_frames=TOL_FRAMES)

    # ---- stage 4: ReSegmentation --------------------------------------
    with stage("resegmentation"):
        rsegs = reseg_main(cfg(
            mixtureDistribCount=K_UBM, inputFeatureFilename="convsp",
            inputWorldFilename="wld", MAPRegFactorMean=3.0,
            loadLabelFileExtension=".seg.lbl",
            saveLabelFileExtension=".reseg.lbl"))["convsp"]
    hyp_rs = score("reseg", rsegs)
    res["der_resegmentation"] = der(ref, hyp_rs)
    res["der_resegmentation_collar25"] = der(ref, hyp_rs,
                                             collar_frames=TOL_FRAMES)

    # ---- turn-driven chain: greedy LLK clustering of the detected
    # turns (bestFittingCluster semantics) → ReSegmentation init --------
    with stage("turn_clustering"):
        world = GmmDiag.load(os.path.join(d, "wld.gmm"), device=dev)
        xj = torch.as_tensor(x_sp, device=dev)
        mcfg = MapCfg(method="MAPOccDep", mean_adapt=True, mean_r=3.0,
                      nb_train_it=1)
        gen = torch.Generator(device=dev).manual_seed(99)
        clusters: list[list[Segment]] = []
        models: list = []

        def bounds(seg):
            return (int(round(seg.begin / FRAME)),
                    min(int(round(seg.end / FRAME)), len(sp_idx)))

        def turn_llk(seg, model):
            return float(segment_mean_llk(xj, [bounds(seg)], model)[0])

        def adapted(segs_):
            mask = np.zeros(len(sp_idx), np.float32)
            for s2 in segs_:
                b, e = bounds(s2)
                mask[b:e] = 1.0
            return adapt_model(gen, xj, torch.as_tensor(mask, device=dev),
                               world, mcfg)

        for seg in turn_segs:
            wl = turn_llk(seg, world)
            self_v = max(turn_llk(seg, adapted([seg])) - wl, 1e-6)
            best = -1
            scores = [turn_llk(seg, m) - wl for m in models]
            if scores:
                best_c = int(np.argmax(scores))
                # join only if the cluster model explains the turn at
                # least 0.65x as well (above the world) as the turn's own
                # adapted model: any MAP model of speech beats the world
                # on speech, so a bare >0 test merges everything
                if scores[best_c] > 0.65 * self_v:
                    best = best_c
            if best < 0 and len(clusters) < 5:
                clusters.append([seg])
            else:
                if best < 0:
                    best = int(np.argmax(scores))
                clusters[best].append(seg)
                models.pop(best)
            ci = best if best >= 0 else len(clusters) - 1
            models.insert(ci, adapted(clusters[ci]))
        turn_lbl = sorted((Segment(s.begin, s.end, f"c{ci}")
                           for ci, cl in enumerate(clusters) for s in cl),
                          key=lambda s: s.begin)
        write_label_file(os.path.join(d, "convsp.turnclust.lbl"), turn_lbl)

    with stage("turn_resegmentation"):
        tsegs = reseg_main(cfg(
            mixtureDistribCount=K_UBM, inputFeatureFilename="convsp",
            inputWorldFilename="wld", MAPRegFactorMean=3.0,
            loadLabelFileExtension=".turnclust.lbl",
            saveLabelFileExtension=".turnreseg.lbl"))["convsp"]

    hyp_tc = full_timeline(segs_to_frames(turn_lbl, len(sp_idx)))
    res["der_turn_clustering"] = der(ref, hyp_tc)
    hyp_tr = score("turnchain", tsegs)
    res["der_turn_resegmentation"] = der(ref, hyp_tr)
    res["der_turn_resegmentation_collar25"] = der(
        ref, hyp_tr, collar_frames=TOL_FRAMES)
    return {
        "milestone": "diarization 4-stage end-to-end (SAD + turns + "
                     "E-HMM + reseg, DER on the full timeline)",
        "device": device_line(dev),
        "shapes": {"minutes": MINUTES, "n_speakers": N_SPK,
                   "K_ubm": K_UBM, "D": D_FEAT},
        "seed": seed,
        "results": res,
        "stage_wall_s": stage.walls,
        "total_wall_s": sum(stage.walls.values()),
        "launches": launches(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    common_args(ap)
    args = ap.parse_args()
    check_device(args.device)
    emit(run(args.workdir or tempfile.mkdtemp(prefix="torch_milestone_diar_"),
             args.device, args.seed), args.out)


if __name__ == "__main__":
    main()
