"""Config 5 record of the PyTorch port (BASELINE.md): i-vectors with a
150-dim G-PLDA and IvNorm, on a sharded trial set.

The counterpart of scripts/milestone_plda.py for lia_ral_tpu_torch, which
imports torch, numpy and the port only.  It drives the port's IvTest
twice over the same 400-dim i-vector corpus (the JAX driver's draws, in
the same order): once serial (``numThread 1``) and once with
``numThread 8``, where PLDA EM shards its sessions and the scoring its
models over a ("data",) mesh of 8 shards (PldaTools.cpp:2647's pthread
pool).  The JAX run made its 8 devices as virtual CPU devices; here the
mesh is 8 shards of the one device (``parallel.mesh.visible_devices``
patched, as chip_smoke.py phase 12 does).  It asserts that the sharded
scores equal the serial ones within 1e-3 of their scale and reports the
EER and minDCF.  PLDA's F and G start from numpy draws of ``--seed``.

Reference anchors: PLDA.cpp:74-99 (train flow), PldaTools.cpp:2647
(threaded E-step), 4061 (threaded scoring), IvTest.cpp:73-706.

Usage: python scripts/torch_milestone_plda.py [--device cuda|cpu]
           [--workdir D] [--seed N] [--out FILE]
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

# corpus v2: rank-normalised speaker scale, so that the per-dim speaker
# std (f_scale*sqrt(plda)) is ~0.37 against within-speaker noise 0.7; a
# dev set large enough to estimate the 400-dim full-covariance Sigma; 200
# target trials give 0.5 % of EER resolution
P = dict(r=400, plda=150, n_dev=300, dev_sess=6, n_spk=50, n_imp=0,
         tests_per_spk=4, f_scale=0.03, noise=0.7)
SHARDS = 8
SHARD_TOL = 1e-3        # sharded against serial scores, of their scale


def gen_vectors(d, p, rng):
    """The JAX driver's synthetic i-vector corpus (same draws in the same
    order): speaker factors through a random rank-``plda`` loading plus
    noise, one .vect file a session, and the dev, target and trial lists.
    Returns (trial segment → speaker, model names)."""
    from lia_ral_tpu_torch.io.lists import write_xlist
    from lia_ral_tpu_torch.io.matrix import write_matrix_file

    r, rank = p["r"], p["plda"]
    f_true = rng.standard_normal((r, rank)) * p["f_scale"]

    def spk_vecs(h, n):
        return (f_true @ h + rng.standard_normal((n, r)) * p["noise"]
                ).astype(np.float32)

    dev_rows = []
    for s in range(p["n_dev"]):
        h = rng.standard_normal(rank)
        names = []
        for j in range(p["dev_sess"]):
            nm = f"dev{s}_{j}"
            write_matrix_file(os.path.join(d, nm + ".vect"),
                              spk_vecs(h, 1)[0][None, :])
            names.append(nm)
        dev_rows.append([f"dspk{s}"] + names)
    enroll_rows, truth, test_names = [], {}, []
    for s in range(p["n_spk"]):
        h = rng.standard_normal(rank)
        nm = f"enr{s}"
        write_matrix_file(os.path.join(d, nm + ".vect"),
                          spk_vecs(h, 1)[0][None, :])
        enroll_rows.append([f"model{s}", nm])
        for j in range(p["tests_per_spk"]):
            tn = f"tst{s}_{j}"
            write_matrix_file(os.path.join(d, tn + ".vect"),
                              spk_vecs(h, 1)[0][None, :])
            test_names.append(tn)
            truth[tn] = s
    models = [m for m, _ in enroll_rows]
    write_xlist(os.path.join(d, "dev.ndx"), dev_rows)
    write_xlist(os.path.join(d, "targets.ndx"), enroll_rows)
    write_xlist(os.path.join(d, "trials.ndx"),
                [[tn] + models for tn in test_names])
    return truth, models


def run(workdir: str, p: dict = P, device: str = "cuda", seed: int = 0
        ) -> dict:
    """The serial and the sharded IvTest runs on ``p``'s corpus under
    ``workdir``; returns the record."""
    from lia_ral_tpu_torch.backend.eval import eer, min_dcf
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.parallel import mesh as pmesh
    from lia_ral_tpu_torch.tools import iv_test

    dev = check_device(device)
    d = workdir
    os.makedirs(d, exist_ok=True)
    stage = Stages(dev)
    with stage("device_warmup"):
        warm_up(dev, libraries=())
    reset_launches()
    with stage("gen_vectors"):
        truth, models = gen_vectors(d, p, np.random.default_rng(20260822))

    base = {
        "loadVectorFilesPath": d + "/", "saveVectorFilesPath": d + "/",
        "matrixFilesPath": d + "/", "vectorFilesExtension": ".vect",
        "targetIdList": os.path.join(d, "targets.ndx"),
        "ndxFilename": os.path.join(d, "trials.ndx"),
        "backgroundNdxFilename": os.path.join(d, "dev.ndx"),
        "scoreMode": "plda", "ivNorm": "true", "ivNormIterationNb": 2,
        "pldaEigenVoiceNumber": p["plda"], "pldaNbIt": 6,
        "gender": "M", "torchDevice": dev.type,
    }

    def score(tag, n_thread):
        return iv_test.main(Config(dict(
            base, outputFilename=os.path.join(d, f"scores_{tag}.nist"),
            numThread=n_thread)))

    visible = pmesh.visible_devices
    with numpy_inits(seed):
        with stage("plda_serial"):
            ser = score("serial", 1)
        pmesh.visible_devices = lambda kind="cuda": [dev] * SHARDS
        try:
            with stage(f"plda_sharded_{SHARDS}"):
                shd = score("sharded", SHARDS)
        finally:
            pmesh.visible_devices = visible

    s_ser = {(ln.model, ln.seg): ln.score for ln in ser}
    s_shd = {(ln.model, ln.seg): ln.score for ln in shd}
    max_dev = max(abs(s_ser[k] - s_shd[k]) for k in s_ser)
    scale = max(abs(v) for v in s_ser.values())
    split = {}
    for tag, lines in (("plda_serial", ser), ("plda_sharded", shd)):
        tgt, imp = [], []
        for ln in lines:
            (tgt if ln.model == f"model{truth[ln.seg]}" else imp).append(
                ln.score)
        split[tag] = (np.asarray(tgt), np.asarray(imp))
    tgt, imp = split["plda_sharded"]
    res = {"plda_eer": eer(tgt, imp), "plda_mindcf": min_dcf(tgt, imp),
           "sharded_vs_serial_max_dev": max_dev,
           "sharded_vs_serial_rel": max_dev / max(scale, 1e-9)}
    if not res["sharded_vs_serial_rel"] < SHARD_TOL:
        raise AssertionError(f"sharded PLDA scores off the serial ones: "
                             f"{res}")
    return {
        "milestone": "config 5 sharded PLDA trial run",
        "device": f"{device_line(dev)} x{SHARDS} shards",
        "shapes": {"R": p["r"], "plda_rank": p["plda"],
                   "n_dev_speakers": p["n_dev"], "n_targets": p["n_spk"],
                   "n_trials": len(truth) * len(models)},
        "seed": seed,
        "results": res,
        "score_stats": {k: score_stats(*v) for k, v in split.items()},
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
    emit(run(args.workdir or tempfile.mkdtemp(prefix="torch_milestone_plda_"),
             P, args.device, args.seed), args.out)


if __name__ == "__main__":
    main()
