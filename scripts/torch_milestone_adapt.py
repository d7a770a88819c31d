"""Unsupervised speaker-adaptation record of the PyTorch port (SpkAdapt,
the NIST unsupervised protocol).

The counterpart of scripts/milestone_adapt.py for lia_ral_tpu_torch, which
imports torch, numpy and the port only.  On the calibrated corpus of
torch_milestone_eer (its ``gen_corpus``, same seed, no dev population) it
runs the port's CLI tools, on the card unless ``--device cpu``:

  static  — ComputeTest top-10 scoring of 1-session target models
  adapted — SpkAdapt (TrainTargetAdapt, SpkAdapt.cpp:90): per target,
            an interleaved target/impostor trial sequence; each trial is
            scored, WMAP maps the score to a target posterior, and the
            model absorbs the trial's frames with that weight.  WMAP's
            score model comes from the znormed static run (the
            development-data convention).
  oracle  — the same with ground-truth weights (Oracle).

Both SpkAdapt runs use online Z-norm (ZNORM + impCohortFile).  Reported:
the EERs overall and on the first and second half of each sequence.
TrainWorld starts from a numpy-made init (``--seed``).

Usage: python scripts/torch_milestone_adapt.py [--device cuda|cpu]
           [--workdir D] [--seed N] [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from torch_milestone_eer import (SCALES, Stages, check_device, common_args,
                                 device_line, emit, gen_corpus, init_gmm,
                                 launches, reset_launches, warm_up)

# the adaptation-friendly regime: 20-s utterances at K=64 give ~30 frames
# a component of adaptation statistics (at 600 frames and K=256, ~2 a
# component, even oracle-weighted adaptation degrades)
P = dict(SCALES["small"], k=64, t_utt=2000, t_test=2000, n_test=6)


def run(workdir: str, p: dict = P, device: str = "cuda", seed: int = 0
        ) -> dict:
    """Static, WMAP-adapted and oracle scoring on ``p``'s corpus under
    ``workdir``; returns the record."""
    from lia_ral_tpu_torch.backend.eval import eer, min_dcf
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.io.features import read_feature_file
    from lia_ral_tpu_torch.io.lists import write_xlist
    from lia_ral_tpu_torch.io.nist import read_nist_scores
    from lia_ral_tpu_torch.tools import (compute_test, norm_feat, spk_adapt,
                                         train_target, train_world)

    dev = check_device(device)
    d = workdir
    os.makedirs(d, exist_ok=True)
    stage = Stages(dev)
    with stage("device_warmup"):
        warm_up(dev)
    reset_launches()
    with stage("gen_corpus"):
        # no TV/PLDA stage here: no dev population
        names = gen_corpus(d, p, np.random.default_rng(20260820),
                           with_dev=False)

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "matrixFilesPath": d + "/",
        "loadFeatureFileFormat": "SPRO4",
        "loadFeatureFileExtension": ".norm.prm",
        "saveMixtureFileFormat": "RAW", "saveMixtureFileExtension": ".gmm",
        "loadMixtureFileExtension": ".gmm",
        "addDefaultLabel": "true", "defaultLabel": "speech",
        "labelSelectedFrames": "speech",
        "mixtureDistribCount": p["k"],
        "initVarianceFlooring": 1.0, "initVarianceCeiling": 10.0,
        "finalVarianceFlooring": 0.5, "finalVarianceCeiling": 5.0,
        "nbTrainIt": p["ubm_it"], "baggedFrameProbability": 1.0,
        "baggedFrameProbabilityInit": 1.0, "torchDevice": dev.type,
    }

    def cfg(**extra):
        return Config(dict(base, **extra))

    all_files = (["bg"] + [n for _, n in names["enroll"]]
                 + [n for _, n in names["test"]]
                 + [n for _, n in names["imp_enroll"]] + names["imp_test"])
    with stage("normfeat_cmvn"):
        with open(os.path.join(d, "allfeat.lst"), "w") as f:
            f.write("\n".join(all_files) + "\n")
        norm_feat.main(cfg(loadFeatureFileExtension=".prm",
                           saveFeatureFileFormat="SPRO4",
                           saveFeatureFileExtension=".norm.prm",
                           inputFeatureFilename=os.path.join(d, "allfeat.lst"),
                           mode="norm"))
    with stage("train_world"):
        bg = read_feature_file(os.path.join(d, "bg.norm.prm"),
                               fmt="SPRO4").data
        init_gmm(bg, p["k"], seed).save(os.path.join(d, "wld_init.gmm"))
        train_world.main(cfg(inputFeatureFilename="bg",
                             inputWorldFilename="wld_init",
                             outputWorldFilename="wld"))
    with stage("train_target"):
        write_xlist(os.path.join(d, "targets.ndx"),
                    [[m, f] for m, f in names["enroll"]])
        train_target.main(cfg(targetIdList=os.path.join(d, "targets.ndx"),
                              inputWorldFilename="wld", MAPAlgo="MAPOccDep",
                              meanAdapt="true", MAPRegFactorMean=14.0,
                              nbTrainIt=3))

    # per-target trial SEQUENCE: its own tests interleaved with other
    # speakers' tests as impostor trials (2 impostors per target trial)
    by_spk: dict[int, list[str]] = {}
    for s, nm in names["test"]:
        by_spk.setdefault(s, []).append(nm)
    seq_rows, truth = [], {}
    n_spk = p["n_spk"]
    for s in range(n_spk):
        tgt = f"model{s}"
        for j, nm in enumerate(by_spk[s]):
            seq_rows.append([nm, tgt])
            truth[(tgt, nm)] = (True, j)
            for o in range(2):
                other = by_spk[(s + 1 + o) % n_spk][j]
                seq_rows.append([other, tgt])
                truth[(tgt, other)] = (False, j)
    write_xlist(os.path.join(d, "adapt_seq.ndx"), seq_rows)

    def split(tag):
        tgt, imp, half = [], [], {}
        for ln in read_nist_scores(os.path.join(d, f"scores_{tag}.nist")):
            is_t, j = truth[(ln.model, ln.seg)]
            (tgt if is_t else imp).append(ln.score)
            half.setdefault(("h2" if j >= p["n_test"] // 2 else "h1", is_t),
                            []).append(ln.score)
        return (np.asarray(tgt), np.asarray(imp),
                {k: np.asarray(v) for k, v in half.items()})

    with stage("static"):
        compute_test.main(cfg(ndxFilename=os.path.join(d, "adapt_seq.ndx"),
                              inputWorldFilename="wld",
                              outputFilename=os.path.join(
                                  d, "scores_static.nist"),
                              gender="M", topDistribsCount=10))
    t_s, i_s, half_s = split("static")

    # online Z-norm (ZNORM + impCohortFile): the cohort is the impostor
    # test files; an adapting model's scores all drift upward, so pooled
    # EER needs per-model-state normalisation
    with open(os.path.join(d, "cohort.lst"), "w") as f:
        f.write("\n".join(names["imp_test"]) + "\n")

    def run_adapt(tag, extra):
        with stage(tag):
            spk_adapt.main(cfg(
                targetIdList=os.path.join(d, "targets.ndx"),
                ndxFilename=os.path.join(d, "adapt_seq.ndx"),
                inputWorldFilename="wld", MAPAlgo="MAPOccDep",
                meanAdapt="true", MAPRegFactorMean=14.0, ZNORM="true",
                impCohortFile=os.path.join(d, "cohort.lst"),
                outputFilename=os.path.join(d, f"scores_{tag}.nist"),
                gender="M", **extra))
        return split(tag)

    # znormed no-adaptation baseline (prior 0: every trial weight 0)
    t_z, i_z, half_z = run_adapt("static_znorm", {"WMAPtarPrior": 0.0})
    wmap_cfg = {
        "WMAPtarMean": float(t_z.mean()), "WMAPtarStd": float(t_z.std()),
        "WMAPimpMean": float(i_z.mean()), "WMAPimpStd": float(i_z.std()),
        "WMAPtarPrior": 0.1,
    }
    t_a, i_a, half_a = run_adapt("adapt", wmap_cfg)
    # oracle upper bound (ground-truth weights, Oracle cpp:1377)
    with open(os.path.join(d, "target_tests.lst"), "w") as f:
        for (tgt, nm), (is_t, _) in truth.items():
            if is_t:
                f.write(f"{tgt} x {nm}\n")
    t_o, i_o, half_o = run_adapt("oracle", {
        "Oracle": "true",
        "targetTests": os.path.join(d, "target_tests.lst")})

    def h_eer(half, h):
        return float(eer(half[(h, True)], half[(h, False)]))

    res = {
        "static_eer": float(eer(t_s, i_s)),
        "static_mindcf": float(min_dcf(t_s, i_s)),
        "static_znorm_eer": float(eer(t_z, i_z)),
        "static_znorm_eer_h1": h_eer(half_z, "h1"),
        "static_znorm_eer_h2": h_eer(half_z, "h2"),
        "adapted_eer": float(eer(t_a, i_a)),
        "adapted_mindcf": float(min_dcf(t_a, i_a)),
        "static_eer_h1": h_eer(half_s, "h1"),
        "static_eer_h2": h_eer(half_s, "h2"),
        "adapted_eer_h1": h_eer(half_a, "h1"),
        "adapted_eer_h2": h_eer(half_a, "h2"),
        "oracle_eer": float(eer(t_o, i_o)),
        "oracle_eer_h1": h_eer(half_o, "h1"),
        "oracle_eer_h2": h_eer(half_o, "h2"),
        "n_target_trials": int(t_s.size),
        "n_impostor_trials": int(i_s.size),
        "wmap": wmap_cfg,
    }
    return {
        "milestone": "unsupervised adaptation (SpkAdapt WMAP sequence "
                     "vs static scoring)",
        "device": device_line(dev),
        "shapes": {"K": p["k"], "D": p["d"], "n_targets": n_spk,
                   "seq_len": p["n_test"] * 3},
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
    emit(run(args.workdir or tempfile.mkdtemp(
        prefix="torch_milestone_adapt_"), P, args.device, args.seed),
        args.out)


if __name__ == "__main__":
    main()
