"""End-to-end EER record of the PyTorch port (BASELINE.md configs 1-3).

The counterpart of scripts/milestone_eer.py for lia_ral_tpu_torch, which
imports torch, numpy and the port only.  It runs the complete file DAG
through the port's CLI tools on the calibrated synthetic NIST-SRE-style
corpus (the JAX driver's ``SCALES`` and ``gen_corpus``, copied: the same
draws in the same order), on the card unless ``--device cpu``:

  GMM-UBM path : CMVN (NormFeat, one call) → TrainWorld → TrainTarget →
                 ComputeTest (top-10, main trials and the Z/T/ZT cohorts)
                 → ComputeNorm (ztnorm) → EER/minDCF
  i-vector path: TotalVariability → IvExtractor → IvTest cosine (IvNorm
                 EFR) and PLDA (median over the init seeds) → EER/minDCF

The dev set (TotalVariability, EFR, PLDA) is a population of speakers
disjoint from the targets and impostors (the NIST protocol).

Random inits: the JAX tools draw theirs from ``jax.random``, the port's
from a ``torch.Generator``, and torch's CPU and CUDA generators differ.
This driver makes them with numpy from ``--seed`` instead, so the card
and the CPU start alike: TrainWorld starts from ``init_gmm`` (written as
``wld_init`` and passed as ``inputWorldFilename``), and ``numpy_inits``
gives TotalVariability's T, PLDA's F and G and JFA's V and U.  A record
is therefore not the JAX driver's record of the same corpus: the UBM
init alone moves the small corpus's raw GMM EER from 14.0 % (the JAX
drivers' init) to 1.0 %, while from the same inits the two packages
agree trial for trial (tests/_torch_milestone_parity.py).

The module also holds what the other ``torch_milestone_*`` drivers share:
the device check, the card's nvidia-smi line, stage walls, launch counts
and the JSON record.

Usage: python scripts/torch_milestone_eer.py [--scale small|full]
           [--tier default|fastStats|fastMath]
           [--ivApprox exact|eigenDecomposition] [--device cuda|cpu]
           [--workdir D] [--seed N] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

SCALES = {
    # model shapes: K, D, R(tv), plda_rank
    # corpus: n_spk(targets), n_imp, dev sessions/spk, frames per
    #   train/dev utt (t_utt), frames per test utt (t_test), test utts
    #   per target (n_test), background frames (bg)
    # hardness: spk_off (per-speaker component-mean offset sigma),
    #   chan (per-session channel offset sigma), noise (frame noise
    #   sigma), alpha (Dirichlet concentration of per-speaker weights:
    #   higher = weaker phonotactic signature)
    "small": dict(k=256, d=24, r=64, plda=32, n_spk=20, n_imp=10,
                  n_dev=100, sess=6, t_utt=600, t_test=300, n_test=10,
                  bg=120_000, ubm_it=4, tv_it=4,
                  spk_off=0.12, chan=0.45, chan_comp=0.18, noise=0.65,
                  alpha=5.0),
    # corpus v3: 300 dev speakers x 10 sessions (3000 dev vectors = 20x
    # the PLDA rank); 240 target trials
    "full": dict(k=2048, d=39, r=400, plda=150, n_spk=40, n_imp=12,
                 n_dev=300, sess=10, t_utt=1200, t_test=300, n_test=6,
                 bg=500_000, ubm_it=6, tv_it=5,
                 spk_off=0.08, chan=0.45, chan_comp=0.25, noise=0.65,
                 alpha=8.0),
}

PLDA_SEEDS = (0, 1, 2)          # the PLDA column is the median over these


def gen_corpus(d, p, rng, with_dev=True):
    """Synthetic NIST-SRE-style corpus over a shared mixture bed (the JAX
    driver's, same draws in the same order).

    Speaker identity lives in the distribution SHAPE — per-speaker
    component weights (phonotactic preference) plus small per-speaker
    component-mean offsets — NOT in a global mean shift, which
    file-level CMVN would remove exactly.  Sessions add a channel offset,
    a per-session per-component channel (which survives CMVN) and noise.
    Targets, impostors and a disjoint dev population."""
    from lia_ral_tpu_torch.io.features import write_feature_file

    k, dim = 64, p["d"]
    centers = rng.standard_normal((k, dim)) * 2.0
    n_all = p["n_spk"] + p["n_imp"] + p["n_dev"]
    spk_weights = rng.dirichlet(np.full(k, p["alpha"]), size=n_all)
    spk_offsets = rng.standard_normal((n_all, k, dim)) * p["spk_off"]

    def utt(spk, n):
        comp = rng.choice(k, size=n, p=spk_weights[spk])
        chan = rng.standard_normal(dim) * p["chan"]
        chan_c = rng.standard_normal((k, dim)) * p["chan_comp"]
        x = (centers[comp] + spk_offsets[spk, comp] + chan + chan_c[comp]
             + rng.standard_normal((n, dim)) * p["noise"])
        return x.astype(np.float32)

    names = {"dev": [], "enroll": [], "test": [], "imp_enroll": [],
             "imp_test": []}
    write_feature_file(os.path.join(d, "bg.prm"),
                       np.concatenate([utt(s % n_all, p["bg"] // n_all + 1)
                                       for s in range(n_all)])[:p["bg"]],
                       fmt="SPRO4")
    for s in range(p["n_dev"] if with_dev else 0):
        for j in range(p["sess"]):
            nm = f"dev_s{s}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(p["n_spk"] + p["n_imp"] + s, p["t_utt"]),
                               fmt="SPRO4")
            names["dev"].append((f"spk{s}", nm))
    for s in range(p["n_spk"]):
        nm = f"enroll_s{s}"
        write_feature_file(os.path.join(d, nm + ".prm"), utt(s, p["t_utt"]),
                           fmt="SPRO4")
        names["enroll"].append((f"model{s}", nm))
        for j in range(p["n_test"]):
            nm = f"test_s{s}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(s, p["t_test"]), fmt="SPRO4")
            names["test"].append((s, nm))
    for s in range(p["n_imp"]):
        nm = f"imp_enroll_{s}"
        write_feature_file(os.path.join(d, nm + ".prm"),
                           utt(p["n_spk"] + s, p["t_utt"]), fmt="SPRO4")
        names["imp_enroll"].append((f"imp{s}", nm))
        for j in range(2):
            nm = f"imp_test_{s}_{j}"
            write_feature_file(os.path.join(d, nm + ".prm"),
                               utt(p["n_spk"] + s, p["t_test"]),
                               fmt="SPRO4")
            names["imp_test"].append(nm)
    return names


# -- shared by the torch_milestone_* drivers ----------------------------------

def check_device(device: str) -> torch.device:
    """``device`` as a torch device; ``cuda`` without a card raises (no
    driver falls back to the CPU: ``--device cpu`` is the way there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch sees no "
                           "CUDA device; pass --device cpu to run on the CPU")
    return dev


def device_line(dev: torch.device) -> str:
    """What a record names its device by: the card's name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit`` gives them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[dev.index or 0]


class Stages:
    """Wall seconds per stage (host clock).  On the card a stage ends in
    a synchronise, so its wall holds the device work it queued."""

    def __init__(self, dev: torch.device) -> None:
        self.dev = dev
        self.walls: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.walls[name] = time.perf_counter() - t0


def warm_up(dev: torch.device, libraries=("gmm_stats",)) -> None:
    """The device's context and the kernel libraries the driver's tools
    load, built (nvcc, at first use) before the first timed stage."""
    torch.ones((8, 8), device=dev) @ torch.ones((8, 8), device=dev)
    if dev.type == "cuda":
        from lia_ral_tpu_torch import _build

        for name in libraries:
            _build.library(name)
        torch.cuda.synchronize(dev)


def reset_launches() -> None:
    from lia_ral_tpu_torch.backend import svm
    from lia_ral_tpu_torch.gmm import cuda_kernels
    from lia_ral_tpu_torch.seg import hmm

    for mod in (cuda_kernels, hmm, svm):
        mod.reset_launch_counts()


def launches() -> dict[str, int]:
    """The kernels' launches since ``reset_launches`` (K1 and K2 by
    arithmetic, the Viterbi and SVM kernels), those that ran."""
    from lia_ral_tpu_torch.backend import svm
    from lia_ral_tpu_torch.gmm import cuda_kernels
    from lia_ral_tpu_torch.seg import hmm

    counts = {**cuda_kernels.launch_counts, **hmm.launch_counts,
              **svm.launch_counts}
    return {k: v for k, v in counts.items() if v}


def init_gmm(frames: np.ndarray, k: int, seed: int = 0):
    """A TrainWorld init made with numpy: ``k`` distinct frames as means
    (drawn by ``np.random.default_rng(seed + k)``), the frames' variance,
    equal weights."""
    from lia_ral_tpu_torch.convert import gmm_from_numpy

    pick = np.random.default_rng(seed + k).choice(frames.shape[0], k,
                                                  replace=False)
    return gmm_from_numpy(np.full(k, 1.0 / k), frames[pick],
                          np.tile(1.0 / frames.var(0), (k, 1)))


# streams of ``normal_init``: one per random matrix of the tools
INIT_STREAMS = {"T": 1, "F": 2, "G": 3, "V": 4, "U": 5}


def normal_init(seed: int, tool_seed: int, stream: str, shape
                ) -> np.ndarray:
    """N(0, 1) draws of one random init matrix (unscaled), from numpy:
    ``seed`` the driver's, ``tool_seed`` the ``randomSeed`` of the tool
    that asks, ``stream`` a key of ``INIT_STREAMS``."""
    rng = np.random.default_rng((seed, tool_seed, INIT_STREAMS[stream]))
    return rng.standard_normal(tuple(shape), dtype=np.float32)


@contextlib.contextmanager
def numpy_inits(seed: int):
    """Inside the block the port's random inits draw from
    ``normal_init``: TotalVariability's T (``init_t``), PLDA's F and G
    (``PldaModel.init``) and JFA's V and U (``JfaModel.init``), each with
    its usual scale; the tool seed is the ``randomSeed`` the tool made its
    generator from."""
    from lia_ral_tpu_torch.backend.plda import PldaModel
    from lia_ral_tpu_torch.fa.jfa import JfaModel
    from lia_ral_tpu_torch.fa.tv import TvModel
    from lia_ral_tpu_torch.tools import total_variability

    def draw(gen, stream, shape, scale, device):
        return torch.from_numpy(normal_init(seed, gen.initial_seed(), stream,
                                            shape) * scale).to(device)

    def init_t(gen, rank, gmm, scale=1.0):
        k, d = gmm.means.shape
        return TvModel.from_ubm(draw(gen, "T", (rank, k, d), scale,
                                     gmm.device), gmm)

    plda_init, jfa_init = PldaModel.init, JfaModel.init

    def plda(cls, gen, dim, rank_f, rank_g=0, data_mean=None, data_cov=None,
             device=None):
        device = gen.device if device is None else device
        m = plda_init.__func__(cls, gen, dim, 0, 0, data_mean, data_cov,
                               device)
        return m.replace(f=draw(gen, "F", (dim, rank_f), 0.1, device),
                         g=draw(gen, "G", (dim, rank_g), 0.1, device))

    def jfa(cls, gen, rank_v, rank_u, gmm, scale=0.001):
        k, d = gmm.means.shape
        m = jfa_init.__func__(cls, gen, 0, 0, gmm, scale)
        return m.replace(v=draw(gen, "V", (rank_v, k, d), scale, gmm.device),
                         u=draw(gen, "U", (rank_u, k, d), scale, gmm.device))

    saved = total_variability.init_t
    total_variability.init_t = init_t
    PldaModel.init, JfaModel.init = classmethod(plda), classmethod(jfa)
    try:
        yield
    finally:
        total_variability.init_t = saved
        PldaModel.init, JfaModel.init = plda_init, jfa_init


def score_stats(tgt: np.ndarray, imp: np.ndarray) -> dict:
    """Trial count, finiteness and mean target / impostor score of one
    score file (what chip_smoke.py checks)."""
    both = np.concatenate([tgt, imp])
    return {"n": int(both.size), "finite": bool(np.isfinite(both).all()),
            "tgt_mean": float(tgt.mean()), "imp_mean": float(imp.mean())}


def emit(summary: dict, out: str | None) -> None:
    """Print the record as one JSON line and append it to ``out``."""
    line = json.dumps(summary)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the numpy-made random inits")
    ap.add_argument("--out", default=None,
                    help="append the JSON record to this file")


# -- the driver ---------------------------------------------------------------

def run(workdir: str, p: dict, device: str = "cuda", tier: str = "default",
        iv_approx: str = "exact", plda_seeds=PLDA_SEEDS, seed: int = 0,
        scale: str = "custom") -> dict:
    """The DAG on ``p``'s corpus under ``workdir``; returns the record
    (results, score statistics, stage walls, launches)."""
    from lia_ral_tpu_torch.backend.eval import eer, min_dcf
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.io.features import read_feature_file
    from lia_ral_tpu_torch.io.lists import write_xlist
    from lia_ral_tpu_torch.io.nist import read_nist_scores
    from lia_ral_tpu_torch.tools import (compute_norm, compute_test,
                                         iv_extractor, iv_test, norm_feat,
                                         total_variability, train_target,
                                         train_world)

    dev = check_device(device)
    d = workdir
    os.makedirs(d, exist_ok=True)
    stage = Stages(dev)
    with stage("device_warmup"):
        warm_up(dev)
    reset_launches()
    with stage("gen_corpus"):
        names = gen_corpus(d, p, np.random.default_rng(20260820))

    base = {
        "featureFilesPath": d + "/", "mixtureFilesPath": d + "/",
        "labelFilesPath": d + "/", "lstPath": d + "/",
        "matrixFilesPath": d + "/",
        "saveVectorFilesPath": d + "/", "loadVectorFilesPath": d + "/",
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
    if tier == "fastStats":
        base["fastStats"] = "true"
    elif tier == "fastMath":
        base["fastMath"] = "true"

    def cfg(**extra):
        return Config(dict(base, **extra))

    all_files = (["bg"] + [n for _, n in names["dev"]]
                 + [n for _, n in names["enroll"]]
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

    # ---- GMM-UBM path ----------------------------------------------------
    with stage("train_world"):
        bg = read_feature_file(os.path.join(d, "bg.norm.prm"),
                               fmt="SPRO4").data
        init_gmm(bg, p["k"], seed).save(os.path.join(d, "wld_init.gmm"))
        train_world.main(cfg(inputFeatureFilename="bg",
                             inputWorldFilename="wld_init",
                             outputWorldFilename="wld"))

    with stage("train_target"):
        write_xlist(os.path.join(d, "targets.ndx"),
                    [[m, f] for m, f in names["enroll"]]
                    + [[m, f] for m, f in names["imp_enroll"]])
        train_target.main(cfg(targetIdList=os.path.join(d, "targets.ndx"),
                              inputWorldFilename="wld", MAPAlgo="MAPOccDep",
                              meanAdapt="true", MAPRegFactorMean=14.0,
                              nbTrainIt=3))

    tgt_models = [m for m, _ in names["enroll"]]
    imp_models = [m for m, _ in names["imp_enroll"]]
    test_segs = [nm for _, nm in names["test"]]

    def run_ct(tag, segs, models):
        write_xlist(os.path.join(d, f"ndx_{tag}"),
                    [[t] + models for t in segs])
        compute_test.main(cfg(ndxFilename=os.path.join(d, f"ndx_{tag}"),
                              inputWorldFilename="wld",
                              outputFilename=os.path.join(
                                  d, f"scores_{tag}.nist"),
                              gender="M", topDistribsCount=10))

    with stage("compute_test"):
        run_ct("main", test_segs, tgt_models)
    with stage("compute_test_cohorts"):
        # znorm: target models × impostor segments (per-model stats);
        # tnorm: impostor models × test segments (per-segment stats)
        run_ct("znorm", names["imp_test"], tgt_models)
        run_ct("tnorm", test_segs, imp_models)
        run_ct("ztnorm", names["imp_test"], imp_models)

    def split_scores(lines):
        tgt, imp = [], []
        for ln in lines:
            spk = int(ln.seg.split("_s")[1].split("_")[0])
            (tgt if ln.model == f"model{spk}" else imp).append(ln.score)
        return np.asarray(tgt), np.asarray(imp)

    stats = {}
    t, i = split_scores(read_nist_scores(os.path.join(d, "scores_main.nist")))
    stats["gmm_raw"] = score_stats(t, i)
    res = {"gmm_raw_eer": eer(t, i), "gmm_raw_mindcf": min_dcf(t, i)}

    with stage("compute_norm_ztnorm"):
        compute_norm.main(cfg(
            normType="ztnorm",
            testNistFile=os.path.join(d, "scores_main.nist"),
            znormNistFile=os.path.join(d, "scores_znorm.nist"),
            tnormNistFile=os.path.join(d, "scores_tnorm.nist"),
            ztnormNistFile=os.path.join(d, "scores_ztnorm.nist"),
            outputFileBaseName=os.path.join(d, "scores_zt.nist")))
    t, i = split_scores(read_nist_scores(os.path.join(d, "scores_zt.nist")))
    stats["gmm_ztnorm"] = score_stats(t, i)
    res["gmm_ztnorm_eer"] = eer(t, i)
    res["gmm_ztnorm_mindcf"] = min_dcf(t, i)

    # ---- i-vector path ---------------------------------------------------
    dev_sessions = [nm for _, nm in names["dev"]]
    approx = ({"approximationMode": "eigenDecomposition"}
              if iv_approx == "eigenDecomposition" else {})
    with numpy_inits(seed):
        with stage("total_variability"):
            write_xlist(os.path.join(d, "tv.ndx"),
                        [[n] for n in dev_sessions])
            total_variability.main(cfg(
                ndxFilename=os.path.join(d, "tv.ndx"),
                inputWorldFilename="wld", totalVariabilityNumber=p["r"],
                totalVariabilityMatrix="TV", meanEstimate="TVmean",
                nbIt=p["tv_it"], initScale=0.5,
                accsFilename=os.path.join(d, "tv_accs.npz"), **approx))

        with stage("iv_extractor"):
            everything = (dev_sessions + [f for _, f in names["enroll"]]
                          + test_segs)
            write_xlist(os.path.join(d, "all.ndx"),
                        [[n] for n in everything])
            iv_extractor.main(cfg(
                ndxFilename=os.path.join(d, "all.ndx"),
                inputWorldFilename="wld", totalVariabilityMatrix="TV",
                meanEstimate="TVmean",
                **({"ivExtractionMode": "eigenDecomposition"} if approx
                   else {})))

        write_xlist(os.path.join(d, "dev.ndx"),
                    [[spk, nm] for spk, nm in names["dev"]])
        write_xlist(os.path.join(d, "iv_targets.ndx"),
                    [[m, f] for m, f in names["enroll"]])
        write_xlist(os.path.join(d, "iv_trials.ndx"),
                    [[t] + tgt_models for t in test_segs])

        def iv_score(mode, extra, tag):
            lines = iv_test.main(cfg(
                targetIdList=os.path.join(d, "iv_targets.ndx"),
                ndxFilename=os.path.join(d, "iv_trials.ndx"),
                backgroundNdxFilename=os.path.join(d, "dev.ndx"),
                scoreMode=mode,
                outputFilename=os.path.join(d, f"scores_iv_{tag}.nist"),
                **extra))
            t, i = split_scores(lines)
            stats[f"iv_{tag}"] = score_stats(t, i)
            return eer(t, i), min_dcf(t, i)

        with stage("iv_test_cosine"):
            res["iv_cosine_eer"], res["iv_cosine_mindcf"] = iv_score(
                "cosine", {"ivNorm": "true", "ivNormIterationNb": 2}, "cos")
        with stage("iv_test_plda"):
            # the median over the PLDA EM init seeds (rank-150 EM from
            # finite dev data is the noisiest stage of the table)
            plda_runs = [iv_score(
                "plda", {"ivNorm": "true", "ivNormIterationNb": 2,
                         "pldaEigenVoiceNumber": p["plda"], "pldaNbIt": 5,
                         "randomSeed": s}, f"plda_s{s}")
                for s in plda_seeds]
    eers = sorted(e for e, _ in plda_runs)
    dcfs = sorted(c for _, c in plda_runs)
    res["iv_plda_eer"] = eers[len(eers) // 2]
    res["iv_plda_mindcf"] = dcfs[len(dcfs) // 2]
    res["iv_plda_eer_seed_spread"] = eers[-1] - eers[0]
    res["iv_plda_eer_seeds"] = eers

    trial_files = set(test_segs) | {f for _, f in names["enroll"]}
    return {
        "milestone": (f"configs 1-3 end-to-end ({scale}, corpus v2"
                      + (f", {tier}" if tier != "default" else "")
                      + (f", ivApprox={iv_approx}"
                         if iv_approx != "exact" else "") + ")"),
        "device": device_line(dev),
        "shapes": {"K": p["k"], "D": p["d"], "R": p["r"],
                   "plda_rank": p["plda"], "n_targets": p["n_spk"],
                   "n_trials": len(test_segs) * len(tgt_models),
                   "n_target_trials": len(test_segs),
                   "n_dev_sessions": len(dev_sessions),
                   "n_dev_speakers": len({s for s, _ in names["dev"]}),
                   "dev_trial_shared_files": len(trial_files
                                                 & set(dev_sessions))},
        "tier": tier, "iv_approx": iv_approx, "seed": seed,
        "plda_seeds": list(plda_seeds),
        "results": {k: ([float(x) for x in v] if isinstance(v, list)
                        else float(v)) for k, v in res.items()},
        "score_stats": stats,
        "stage_wall_s": stage.walls,
        "total_wall_s": sum(stage.walls.values()),
        "launches": launches(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="small", choices=list(SCALES))
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--tier", default="default",
                    choices=["default", "fastStats", "fastMath"],
                    help="numerics tier of K1/K2 (fastStats = bf16nx: bf16 "
                         "S/F sums with exact f32 occupancies; fastMath = "
                         "bf16 densities)")
    ap.add_argument("--ivApprox", default="exact",
                    choices=["exact", "eigenDecomposition"],
                    help="i-vector extraction mode (IvExtractor.cpp:253 "
                         "eigen-decomposition approximation)")
    common_args(ap)
    args = ap.parse_args()
    check_device(args.device)
    emit(run(args.workdir or tempfile.mkdtemp(prefix="torch_milestone_"),
             SCALES[args.scale], args.device, args.tier, args.ivApprox,
             seed=args.seed, scale=args.scale), args.out)


if __name__ == "__main__":
    main()
