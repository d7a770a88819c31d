"""North-star parity of the PyTorch port: its CLI chain against the f64
reference-semantics oracle (native/oracle.cpp).

The counterpart of scripts/oracle_parity.py for lia_ral_tpu_torch, which
imports torch, numpy and the port only.  It

  1. writes the calibrated milestone corpus (a copy of
     scripts/milestone_eer.py's ``gen_corpus`` and ``SCALES["small"]``,
     written through the port's ``write_feature_file``),
  2. runs the port's CLI tools on it (NormFeat → TrainWorld →
     TrainTarget → ComputeTest top-10; TotalVariability → IvExtractor),
     on the card by default (``--device cpu`` for the plain versions),
  3. builds native/oracle.cpp with the Makefile's flags (no fast-math)
     into the port's build directory and runs it stage by stage from the
     chain's own inputs, and as an independent f64 chain from the same
     init,
  4. prints the deviation of each stage (max and mean) and
     ``eer_delta_vs_oracle`` for the GMM raw path and the i-vector cosine
     path, beside the JAX package's figures of PARITY.md.

Stages (each consumes the chain's inputs, so a deviation pins the stage
that made it): em (oracle EM from the chain's init vs its UBM), map
(oracle MAP from the chain's UBM vs its client models), score (oracle
top-10 LLR with the chain's models vs its score file, per trial), ivec
(oracle BW stats + exact estimateW with the chain's T vs its i-vectors;
cosine trial scores of both).

Usage: python scripts/torch_oracle_parity.py [--scale small] [--device
       cuda|cpu] [--workdir D] [--threads N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

# scripts/milestone_eer.py's SCALES["small"] (model K, D, R; corpus; the
# hardness knobs: per-speaker offsets, per-session channel, noise, the
# Dirichlet concentration of the per-speaker weights)
SCALES = {
    "small": dict(k=256, d=24, r=64, plda=32, n_spk=20, n_imp=10,
                  n_dev=100, sess=6, t_utt=600, t_test=300, n_test=10,
                  bg=120_000, ubm_it=4, tv_it=4,
                  spk_off=0.12, chan=0.45, chan_comp=0.18, noise=0.65,
                  alpha=5.0),
}

# the JAX package's run of scripts/oracle_parity.py (PARITY.md, the
# "North-star" table): max and mean deviation per stage
JAX_FIGURES = {
    "em_weights": (2.5e-4, 5.6e-5), "em_means": (7.3e-4, 2.0e-5),
    "em_cov": (1.6e-4, 5.4e-6), "map_means": (3.8e-4, 2.2e-6),
    "score_llr": (6.6e-5, 3.0e-5), "chain_llr": (1.7e-4, 3.5e-5),
    "ivector": (1.2e-4, 2.2e-5), "iv_cosine_scores": (3.2e-5, 6.9e-6),
    "gmm_eer_delta_vs_oracle": 0.0, "iv_eer_delta_vs_oracle": 0.0,
}


def gen_corpus(d, p, rng, with_dev=True):
    """Synthetic NIST-SRE-style corpus over a shared mixture bed (copy of
    scripts/milestone_eer.py's, same draws in the same order).  Speaker
    identity lives in per-speaker component weights and small
    per-speaker component-mean offsets; sessions add a channel offset, a
    per-component channel and noise."""
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


def write_bin(path: str, arr: np.ndarray) -> None:
    """The oracle's array file: ndim, the dims (int64), then f64 data."""
    arr = np.ascontiguousarray(arr, np.float64)
    with open(path, "wb") as f:
        np.asarray([arr.ndim], np.int64).tofile(f)
        np.asarray(arr.shape, np.int64).tofile(f)
        arr.tofile(f)


def read_bin(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        nd = int(np.fromfile(f, np.int64, 1)[0])
        dims = np.fromfile(f, np.int64, nd)
        return np.fromfile(f, np.float64).reshape(dims)


def gmm_to_rows(g) -> np.ndarray:
    """(K, 2D+1) oracle model layout: [w, mean, cov]."""
    w = g.weights.cpu().numpy().astype(np.float64)[:, None]
    mu = g.means.cpu().numpy().astype(np.float64)
    cov = 1.0 / g.cov_inv.cpu().numpy().astype(np.float64)
    return np.concatenate([w, mu, cov], axis=1)


def rows_to_arrays(rows: np.ndarray):
    d = (rows.shape[1] - 1) // 2
    return rows[:, 0], rows[:, 1:1 + d], rows[:, 1 + d:]


def rel_dev(a, b) -> dict:
    """max/mean relative deviation |a-b| / (|b| + mean|b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).mean() + 1e-12
    r = np.abs(a - b) / (np.abs(b) + scale)
    return {"max": float(r.max()), "mean": float(r.mean())}


def abs_dev(a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {"max": float(d.max()), "mean": float(d.mean())}


def run_chain(d: str, p: dict, names: dict, device: str) -> dict:
    """The port's CLI chain on the corpus under ``d``; returns the config
    keys every tool took (for reading its outputs back)."""
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.io.lists import write_xlist
    from lia_ral_tpu_torch.tools import (compute_test, iv_extractor,
                                         norm_feat, total_variability,
                                         train_target, train_world)

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
        "baggedFrameProbabilityInit": 1.0, "torchDevice": device,
    }

    def cfg(**extra):
        return Config(dict(base, **extra))

    all_files = (["bg"] + [n for _, n in names["dev"]]
                 + [n for _, n in names["enroll"]]
                 + [n for _, n in names["test"]]
                 + [n for _, n in names["imp_enroll"]] + names["imp_test"])
    with open(os.path.join(d, "allfeat.lst"), "w") as f:
        f.write("\n".join(all_files) + "\n")
    norm_feat.main(cfg(loadFeatureFileExtension=".prm",
                       saveFeatureFileFormat="SPRO4",
                       saveFeatureFileExtension=".norm.prm",
                       inputFeatureFilename=os.path.join(d, "allfeat.lst"),
                       mode="norm"))
    train_world.main(cfg(inputFeatureFilename="bg",
                         outputWorldFilename="wld",
                         outputInitWorldFilename="wld_init"))
    write_xlist(os.path.join(d, "targets.ndx"),
                [[m, f] for m, f in names["enroll"]]
                + [[m, f] for m, f in names["imp_enroll"]])
    train_target.main(cfg(targetIdList=os.path.join(d, "targets.ndx"),
                          inputWorldFilename="wld", MAPAlgo="MAPOccDep",
                          meanAdapt="true", MAPRegFactorMean=14.0,
                          nbTrainIt=3))
    tgt_models = [m for m, _ in names["enroll"]]
    write_xlist(os.path.join(d, "ndx_main"),
                [[t] + tgt_models for _, t in names["test"]])
    compute_test.main(cfg(ndxFilename=os.path.join(d, "ndx_main"),
                          inputWorldFilename="wld",
                          outputFilename=os.path.join(d, "scores_main.nist"),
                          gender="M", topDistribsCount=10))
    write_xlist(os.path.join(d, "tv.ndx"), [[n] for _, n in names["dev"]])
    total_variability.main(cfg(ndxFilename=os.path.join(d, "tv.ndx"),
                               inputWorldFilename="wld",
                               totalVariabilityNumber=p["r"],
                               totalVariabilityMatrix="TV",
                               meanEstimate="TVmean", nbIt=p["tv_it"],
                               initScale=0.5))
    iv_names = ([f for _, f in names["enroll"]]
                + [n for _, n in names["test"]])
    write_xlist(os.path.join(d, "iv.ndx"), [[n] for n in iv_names])
    iv_extractor.main(cfg(ndxFilename=os.path.join(d, "iv.ndx"),
                          inputWorldFilename="wld",
                          totalVariabilityMatrix="TV",
                          meanEstimate="TVmean"))
    return base


def run(workdir: str, p: dict, device: str = "cuda", threads: int = 8,
        seed: int = 20260820) -> dict:
    """The chain and the oracle on ``p``'s corpus under ``workdir``.
    Returns {"results": per-stage deviations and EERs, "wall_s": ...}."""
    from lia_ral_tpu_torch._build import host_build
    from lia_ral_tpu_torch.backend.eval import eer
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.gmm.model import GmmDiag
    from lia_ral_tpu_torch.io.features import read_feature_file
    from lia_ral_tpu_torch.io.matrix import read_matrix_file
    from lia_ral_tpu_torch.io.nist import read_nist_scores
    from lia_ral_tpu_torch.tools.iv_norm import load_vectors

    d = workdir
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    oracle = str(host_build("oracle"))
    t_build = time.perf_counter() - t0

    stage_s: dict[str, float] = {}       # wall s of each oracle stage
    running: dict = {}

    def start(tag, *args) -> None:
        """The oracle's subcommand (``tag``'s first word) on ``args``,
        started."""
        running[tag] = (subprocess.Popen(
            [oracle, tag.split()[0], *[str(a) for a in args]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            time.perf_counter())

    def finish(tag) -> None:
        proc, t1 = running.pop(tag)
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"oracle {tag} failed: {err[-2000:]}")
        stage_s[tag] = stage_s.get(tag, 0.0) + time.perf_counter() - t1

    def run_oracle(tag, *args) -> None:
        start(tag, *args)
        finish(tag)

    t0 = time.perf_counter()
    names = gen_corpus(d, p, np.random.default_rng(seed))
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = run_chain(d, p, names, device)
    t_chain = time.perf_counter() - t0

    # -- exports -----------------------------------------------------------
    t0 = time.perf_counter()
    ob = os.path.join(d, "oracle")
    os.makedirs(ob, exist_ok=True)

    def feats(name: str) -> np.ndarray:
        return read_feature_file(os.path.join(d, name + ".norm.prm"),
                                 fmt="SPRO4").data.astype(np.float64)

    def load_gmm(name: str):
        return GmmDiag.load(os.path.join(d, name + ".gmm"))

    bg = feats("bg")
    write_bin(f"{ob}/bg.bin", bg)
    write_bin(f"{ob}/init.bin", gmm_to_rows(load_gmm("wld_init")))
    wld = load_gmm("wld")
    write_bin(f"{ob}/wld.bin", gmm_to_rows(wld))
    tgt_models = [m for m, _ in names["enroll"]]
    enroll_files = dict(names["enroll"])
    write_bin(f"{ob}/clients_pipeline.bin",
              np.stack([gmm_to_rows(load_gmm(m)) for m in tgt_models]))
    test_segs = [nm for _, nm in names["test"]]

    def write_frames(prefix, seg_names):
        xs = [feats(nm) for nm in seg_names]
        off = np.zeros(len(xs) + 1, np.float64)
        off[1:] = np.cumsum([x.shape[0] for x in xs])
        write_bin(f"{ob}/{prefix}_feats.bin", np.concatenate(xs))
        write_bin(f"{ob}/{prefix}_offsets.bin", off)

    write_frames("test", test_segs)
    k, dim, r = p["k"], p["d"], p["r"]
    write_bin(f"{ob}/T.bin", read_matrix_file(
        os.path.join(d, "TV.matx")).reshape(r, k, dim))
    write_bin(f"{ob}/TVmean.bin", read_matrix_file(
        os.path.join(d, "TVmean.matx")).reshape(k, dim))
    iv_names = [enroll_files[m] for m in tgt_models] + test_segs
    write_frames("iv", iv_names)

    # -- oracle stages -----------------------------------------------------
    # the scoring and the i-vectors from the chain's own models run on one
    # core each, beside the EM and MAP chain's threads
    start("score", f"{ob}/wld.bin", f"{ob}/clients_pipeline.bin",
          f"{ob}/test_feats.bin", f"{ob}/test_offsets.bin", 10,
          f"{ob}/llr_isolated.bin")
    start("ivec", f"{ob}/wld.bin", f"{ob}/T.bin", f"{ob}/TVmean.bin",
          f"{ob}/iv_feats.bin", f"{ob}/iv_offsets.bin", f"{ob}/w_oracle.bin")
    run_oracle("em", f"{ob}/bg.bin", f"{ob}/init.bin", p["ubm_it"], 1.0, 0.5,
               10.0, 5.0, threads, f"{ob}/wld_oracle.bin")
    ow_w, ow_mu, ow_cov = rows_to_arrays(read_bin(f"{ob}/wld_oracle.bin"))
    res = {"em_weights": rel_dev(wld.weights.numpy(), ow_w),
           "em_means": rel_dev(wld.means.numpy(), ow_mu),
           "em_cov": rel_dev(1.0 / wld.cov_inv.numpy(), ow_cov)}
    chain_rows, map_devs = [], []
    for m in tgt_models:
        write_bin(f"{ob}/enr.bin", feats(enroll_files[m]))
        run_oracle("map", f"{ob}/enr.bin", f"{ob}/wld.bin", 14.0, 3,
                   threads, f"{ob}/cl.bin")
        _, cmu, _ = rows_to_arrays(read_bin(f"{ob}/cl.bin"))
        map_devs.append(rel_dev(load_gmm(m).means.numpy(), cmu))
        run_oracle("map", f"{ob}/enr.bin", f"{ob}/wld_oracle.bin", 14.0, 3,
                   threads, f"{ob}/cl_chain.bin")
        chain_rows.append(read_bin(f"{ob}/cl_chain.bin"))
    res["map_means"] = {"max": max(v["max"] for v in map_devs),
                        "mean": float(np.mean([v["mean"]
                                               for v in map_devs]))}
    write_bin(f"{ob}/clients_chain.bin", np.stack(chain_rows))
    # the independent f64 chain: the oracle's own UBM and clients
    start("score chain", f"{ob}/wld_oracle.bin", f"{ob}/clients_chain.bin",
          f"{ob}/test_feats.bin", f"{ob}/test_offsets.bin", 10,
          f"{ob}/llr_chain.bin")
    # scoring with the chain's world and clients
    finish("score")
    llr_oracle = read_bin(f"{ob}/llr_isolated.bin")      # (U, C)
    mod_idx = {m: i for i, m in enumerate(tgt_models)}
    seg_idx = {s: i for i, s in enumerate(test_segs)}
    llr_chain_tools = np.zeros_like(llr_oracle)
    for line in read_nist_scores(os.path.join(d, "scores_main.nist")):
        llr_chain_tools[seg_idx[line.seg], mod_idx[line.model]] = line.score
    res["score_llr"] = abs_dev(llr_chain_tools, llr_oracle)

    def to_eer(llr: np.ndarray) -> float:
        tgt, imp = [], []
        for si, seg in enumerate(test_segs):
            spk = int(seg.split("_s")[1].split("_")[0])
            for mi, m in enumerate(tgt_models):
                (tgt if m == f"model{spk}" else imp).append(llr[si, mi])
        return float(eer(np.asarray(tgt), np.asarray(imp)))

    finish("score chain")
    llr_f64 = read_bin(f"{ob}/llr_chain.bin")
    res["gmm_eer_port"] = to_eer(llr_chain_tools)
    res["gmm_eer_oracle_chain"] = to_eer(llr_f64)
    res["gmm_eer_delta_vs_oracle"] = abs(res["gmm_eer_port"]
                                         - res["gmm_eer_oracle_chain"])
    res["chain_llr"] = abs_dev(llr_chain_tools, llr_f64)
    # i-vectors: oracle BW stats + exact estimateW with the chain's T
    finish("ivec")
    w_oracle = read_bin(f"{ob}/w_oracle.bin")            # (U, R)
    w_port = load_vectors(iv_names, Config(base)).astype(np.float64)
    res["ivector"] = abs_dev(w_port, w_oracle)
    res["ivector_scale"] = float(np.abs(w_oracle).max())
    res["ivector_norm"] = float(np.abs(w_port).mean())
    n_models = len(tgt_models)

    def cosine(w: np.ndarray) -> np.ndarray:
        wn = w / np.linalg.norm(w, axis=1, keepdims=True)
        return wn[n_models:] @ wn[:n_models].T

    res["iv_cosine_eer_port"] = to_eer(cosine(w_port))
    res["iv_cosine_eer_oracle"] = to_eer(cosine(w_oracle))
    res["iv_eer_delta_vs_oracle"] = abs(res["iv_cosine_eer_port"]
                                        - res["iv_cosine_eer_oracle"])
    res["iv_cosine_scores"] = abs_dev(cosine(w_port), cosine(w_oracle))
    t_oracle = time.perf_counter() - t0
    return {"results": res,
            "shapes": {"K": k, "D": dim, "R": r,
                       "n_trials": len(test_segs) * n_models,
                       "bg_frames": int(bg.shape[0])},
            "wall_s": {"oracle_build": t_build, "corpus": t_corpus,
                       "chain": t_chain, "oracle": t_oracle,
                       **{f"oracle {k}": v for k, v in stage_s.items()}}}


def report(res: dict) -> list[str]:
    """One line per stage: the port's max and mean deviation beside the
    JAX package's (PARITY.md), then the EER deltas."""
    lines = []
    for stage in ("em_weights", "em_means", "em_cov", "map_means",
                  "score_llr", "chain_llr", "ivector", "iv_cosine_scores"):
        jmax, jmean = JAX_FIGURES[stage]
        lines.append(f"{stage:17s} port max {res[stage]['max']:.2e} mean "
                     f"{res[stage]['mean']:.2e} | JAX package max "
                     f"{jmax:.1e} mean {jmean:.1e}")
    lines.append(f"eer_delta_vs_oracle GMM raw {res['gmm_eer_delta_vs_oracle']:.4f}"
                 f" (port {100 * res['gmm_eer_port']:.2f} %, oracle "
                 f"{100 * res['gmm_eer_oracle_chain']:.2f} %); i-vector "
                 f"cosine {res['iv_eer_delta_vs_oracle']:.4f} (port "
                 f"{100 * res['iv_cosine_eer_port']:.2f} %, oracle "
                 f"{100 * res['iv_cosine_eer_oracle']:.2f} %) | JAX "
                 "package 0.0 and 0.0")
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="small", choices=sorted(SCALES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = run(args.workdir or tempfile.mkdtemp(prefix="torch_oracle_"),
              SCALES[args.scale], args.device, args.threads)
    for line in report(out["results"]):
        print(line)
    summary = {"milestone": "port parity vs f64 reference-semantics oracle",
               "device": args.device, **out}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
