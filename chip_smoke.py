#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lia_ral_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (nvcc).  The script imports nothing of JAX.  Phases, each
printed as it ends; any failure raises and the exit code is non-zero:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds the kernels of csrc/ into the ignored build dir,
            one process per source, side by side, and g++ builds
            native/liaio.cpp (the feature reader) and native/oracle.cpp
            (the f64 parity oracle) beside them
3. slice    the library path at full width on a synthetic corpus (1M
            frames = 10,000 audio-s, 500 utterances × 2000 frames, 50
            speakers): mixture_init → train_model (K=2048, 3 EM
            iterations) → bw_stats_batch → init_t (R=400) → estimate_w
            (PCG) → cosine_scores → eer.  Checks finite outputs, meanLLK
            non-decreasing within 1e-3 nats/frame, both kernels launched,
            and the i-vectors of a rerun through the plain stats paths
            from the same init within 1e-3·max|w|.
4. tiers    K1 on the slice's 1M frames and K2 on its 500 × 2000, with
            the slice's UBM, against their plain versions in each tier
            (the K1/K2 budgets, llk, count; closer to its own tier's
            plain version than to another's; a rerun equal to the
            digit), each timed beside the least time the card could take.
5. cli      the same corpus as 500 SPRO4 files with .lbl files, through
            ``python -m lia_ral_tpu_torch`` entry points in-process:
            TrainWorld (3 EM iterations) → TotalVariability (R=400, 2
            iterations) → IvExtractor (PCG) → IvTest (cosine, 50 models
            of 5 sessions × 250 test segments = 12,500 trials), once in
            the default tier and once with fastStats=true; then
            TrainWorld alone with fastMath=true, and with both keys (no
            tool passes fastMath to K2).  Checks the score files,
            meanLLK, the tier kernels' launch counts (each run's own,
            counted from 0), and that the final UBMs agree in meanLLK
            with the default chain's within 1e-2 (fastStats) and 5e-2
            (fastMath).  Times each tool (host clock) and the kernels
            inside it (CUDA events around each wrapper call).  Every
            feature file goes through the native reader (its read counts:
            not one numpy read of these SPRO4 files).
6. gmm-ubm  the GMM-UBM system of configs 1 and 2 at full width: phase
            6's corpus (seed 0, speakers also differing by per-component
            offsets) as 500 SPRO4 files with a 40th log-energy column,
            through ``python -m lia_ral_tpu_torch`` entry points
            in-process: EnergyDetector (column 39, 3 components, 10
            iterations) → NormFeat (columns 0-38, file CMVN; featWarp on
            50 files) → TrainWorld (K=2048, 3 iterations, sessions 0-4)
            → TrainTarget (MAPOccDep means, r=14, 3 iterations; 40
            targets and 10 cohort models of 5 sessions) → ComputeTest
            (top-10; 200 test segments × 40 targets, and the Z, T and
            ZT lists) → ComputeNorm (ztnorm).  Checks each score file's
            trial count and finite scores, mean target above mean
            impostor score raw and ZT-normed, K1 launched by
            EnergyDetector, TrainWorld and TrainTarget (counts reset
            before the phase), and, at library level, adapt_model for 5
            clients through K1 (reproducing TrainTarget's files) against
            the plain stats path on the card: means within 1e-3·max|μ|,
            LLRs on 20 test segments within 1e-3.  Prints each tool's
            wall time, K1's device ms and launches per tool, and the raw
            and ZT-norm EER.  The tools read natively (read counts, no
            numpy read); then the 500 raw files are read through each
            reader (the native batched loader and numpy), timed, and the
            arrays held equal to the digit.
7. backend  the i-vector back end of configs 3 and 5 (K=2048, D=39,
            R=400) on phase 5's default-tier chain, whose
            TotalVariability call also writes the eigenDecomposition
            matrices and a stats checkpoint: the ubmWeight matrix
            (``weighted_cov``) and IvExtractor in ubmWeight mode from
            the checkpoint (no launch) and in eigenDecomposition mode
            (K2, counted under its own path) → IvNorm (EFR, 2
            iterations) → PLDA (rank 150, 10 iterations) → IvTest on
            the 12,500 trials with cosine + WCCN, mahalanobis, 2cov,
            plda, and LDA (rank 49, estimated inside IvTest with
            ivNorm).  The corpus has no separate dev set: all 500
            i-vectors (50 speakers × 10 sessions, the trials' own)
            estimate every back-end matrix, so the EERs are optimistic;
            PLDA's rank exceeds the speaker count.  Checks 12,500
            finite scores per mode, mean target above mean impostor
            score for cosine + WCCN, plda and 2cov, IvNorm's vectors
            of unit norm and equal to ``apply_efr`` of its saved files,
            a rerun of IvNorm → PLDA → IvTest (plda) equal to the digit,
            and every library function of the TV approximations,
            ivnorm, scoring and plda on the card against the CPU from
            the same inputs within 1e-3 of scale (through invariants
            where an eigensolver or QR leaves signs open).
8. jfa     the JFA system of config 4 (300 eigenvoices, 100
            eigenchannels, D) on phase 6's normalised features, labels,
            world model and clients: ComputeJFAStats on the 250
            training sessions (K2) → EigenVoice → EigenChannel →
            EstimateDMatrix from the checkpoint (2 iterations each) →
            TrainTarget channelCompensation=JFA on the 40 targets (K2;
            D = sqrt(Σ/16), since EstimateDMatrix's D stays at its zero
            init) → ComputeTest jfa on the 8,000 main trials; NormFeat
            featLFA on 50 files and ComputeTest lfa on 20 segments.
            Checks K2's launches per tool against the bucketing rule
            (0 in the loadAccs tools), V and U finite and moved, the
            library's V iterations equal to EigenVoice's file and the
            EM likelihood of 2 sessions non-decreasing over them, the D
            update from a non-zero D, the scores.  Prints walls, K2 ms
            and launches per tool, the EER beside phase 6's raw EER and
            the phase's peak device memory.

9. diar    diarization at the milestone shape of
            scripts/milestone_diar.py (the generator, init models and
            scoring helpers of its counterpart
            scripts/torch_milestone_diar.py): a 5-minute conversation of
            3 speakers with silence and music, 30,000 frames, D=24,
            through ``python -m lia_ral_tpu_torch`` entry points
            in-process: TrainWorld (three event GMMs of
            K=32 on bootstrap samples) → AcousticSegmentation →
            TrainWorld (world, K=128, on the detected speech) →
            TurnDetection → Segmentation (E-HMM, maxSpeakers 5,
            MAPRegFactorMean 3) → ReSegmentation.  Checks the SAD frame
            error, 3 of 3 speakers found, the DER after Segmentation and
            after ReSegmentation (``backend.eval.der``, collar 0 and 25
            frames) under ``DIAR_DER_LIMIT``, K1's and the Viterbi
            kernel's launches per tool against the counts the loops
            imply, and a rerun of Segmentation equal to the digit; K1's
            grouped entry (the state adaptations' one launch a MAP
            iteration) on the Segmentation's own state masks and their
            adapted states, each row within the K1 budgets of the plain
            version of its own frames, an empty row exact zeros.  Then
            the Viterbi kernel against the plain loop for exact equality
            of the path (N=30,000 S=5; N=1 S=1; inactive states; a
            60,000-frame decode; every instance S = 1, 2, 3, 5, 8, 9, 16,
            17, 32 at the ring's and the backtrace's chunk edges; back
            pointers filling shared memory and one row over), timed at
            N=30,000 and 60,000 with ns and SM cycles a step beside the
            chain's estimate.
10. serving a ``SpkDetServer`` on an ephemeral localhost port with phase
            8's world (K=2048, D=39) and normalised features, driven
            through ``RemoteSpkDetClient``: load_world, send_features +
            train_speaker for the 40 targets, verify on a target and an
            impostor trial each, identify over the 40 speakers,
            cumulative scores, adapt_speaker.  Checks every LLR against
            ``gmm.scoring.compute_test_llr`` on the same frames (1e-3),
            3 K1 launches per train_speaker, mean target score above
            the threshold above the mean impostor score; prints the
            median and p95 latency of 50 verify and 50 identify calls
            (host clock around the client call).  Then the audio path at
            8 kHz with a K=128 world (send_audio → MFCC + deltas →
            normalize_features → train, verify), and SpkAdapt on 10
            targets of phase 6 (WMAP, without and with online ZNORM).
11. gmm-svm the GMM-supervector SVM system and the twenty LIA_Utils
            tools, on phase 6's world (K=2048, D=39: supervectors of
            79,872 dimensions), features, models and 8,000 main trials,
            through ``python -m lia_ral_tpu_torch`` entry points
            in-process: TrainTarget outputAdaptParam (KL supervectors of
            the 250 training sessions and the 200 test segments, 3 K1
            launches each) → CovIntra (rank 40, on the 250) → NAPSV (all
            450) → SvmTrain (40 targets: 5 napped sessions against the 50
            cohort vectors, N = 55, linear, default C; one launch of the
            SVM dual kernel each) → SvmPredict (8,000 trials); ModelToSv
            (meanSv, weightSv, normSv) on the 40 targets; TrainTarget NAP
            (40 targets, K1), ComputeTest nap and dotProduct (napMatrix)
            on the 8,000 trials, NormFeat featNAP on 50 files; then
            Scoring (NIST, identification), FusionScore, ScoreWarp, Hist on
            phase 6's score files, ReadModel, ReadFeatFile, ExtractParams
            (10 files), PolyExp (50 files; computeR, normalize, default),
            GmmTokenizer (symbols, confusion matrix), BNGram (orders 1-3),
            LabelNGram, SequenceExtractor, SequenceDecode on the token
            streams, LabelFusion and TimeCluster on phase 9's labels.
            Checks each score file's trial count and finite scores, mean
            target above mean impostor score for SVM, nap and dotProduct,
            K1 and svm_dual launches per tool against the counts the loops
            imply (one svm_dual launch a target), every tool's outputs,
            and CovIntra's subspace, PolyExp (first 10 files), SvmPredict's
            scores and GmmTokenizer's per-frame symbols against the same
            tool run with ``torchDevice cpu`` within 1e-3 of scale.  Then
            the SVM dual kernel against its plain loop (N = 55 from the
            main path, linear, rbf, linear with targetPenalty; N = 1,001,
            a synthetic background at d = 79,872, linear and rbf; the
            plan's regime edges N = 64, 65, 232, 233, 600, 928, 929 and
            4,096): α,
            decisions, the dual objective, a rerun equal to the digit,
            times at N = 55, 1,001, 4,096 (median of 3; µs a FISTA step;
            the chain estimate; the plain loop on the card once).  Prints
            each tool's wall, K1 and svm_dual device ms and launches per
            tool, the SVM, nap and dotProduct EERs.
12. parallel numThread on the one card: meshes of shards of cuda:0 (one
            thread and one CUDA stream a shard, collectives reducing in
            shard order).  sharded_stats_fn on a 4 × 1 mesh at 1M frames,
            K=2048, D=39, default and fastStats (K1 4 times a call,
            against serial K1 within the K1 budgets, count exact);
            sharded_em_stats_2d on 2 × 2 against em_stats_chunked;
            sharded_tv_e_step (4 × 1) and sharded_tv_e_step_2d (2 × 2) on
            phase 5's stats and T (500 utterances, R=400; peak memory
            printed); sharded_estimate_w (pcg_tol 0); the JFA V and U
            iterations on phase 8's stats and subspaces; PLDA EM and
            scoring on phase 7's normalised vectors and PLDA model: each
            within 1e-3 of scale of its serial function and a rerun
            equal to the digit.  TrainWorld (K1 4 times an iteration) and
            TotalVariability with numThread 4, the visible-devices
            function patched to 4 shards of the card (T within rtol 2e-3,
            atol 2e-4 of numThread 1's), and without the patch (no mesh,
            T equal to the digit).  Two processes on cuda:0 under gloo
            (tests/_torch_multihost_worker.py): global_stats with K1 on
            half the 1M frames each (once a rank, within the K1 budgets
            of single-process K1), then the PLDA, TV, JFA V and
            extraction problems of tests/_multihost_worker.py, the ranks
            equal to the digit.  Then K1 at 1M frames timed serial and
            sharded.
13. oracle  scripts/torch_oracle_parity.py at scale small (K=256, D=24,
            R=64, 4000 trials): the port's chain on the card against the
            f64 oracle stage by stage; per-trial LLR within 1e-3 and
            i-vectors within 1e-3 of scale; the deviations and both EER
            deltas printed beside the JAX package's.
14. milestones the record drivers of scripts/ (torch_milestone_*.py,
            imported; their ``run`` functions) through the port's tools
            and API on the card: eer at full width (K=2048, D=39, R=400,
            PLDA rank 150, corpus v3: 300 held-out dev speakers x 10
            sessions, 9,600 trials of which 240 target; default tier; cut:
            one PLDA seed, not the median of 3), jfa at scale small (K=64,
            channel variation in a rank-8 subspace), plda (R=400, rank
            150, 10,000 trials; serial against 8 shards of the card),
            adapt (SpkAdapt WMAP, K=64) and audio (waveform to decision,
            K=128, a TCP verify).  Checks: the eer dev set is speakers of
            its own and shares no file with the trials; every score file
            holds its trial count of finite scores with mean target above
            mean impostor (raw, ZT-norm, cosine, PLDA; jfa; plda serial
            and sharded); the PLDA EER under ``MS_PLDA_EER_LIMIT``;
            sharded PLDA within ``PAR_TOL`` of scale of serial; the
            adapted EER no higher than the static one; audio scores
            finite with mean target above mean impostor; K1 launched by
            eer, adapt and audio, K2 by eer and jfa.  Prints every EER,
            the verify latencies, the stage walls and launches of each.

K1 and K2 in the arithmetics beyond the tiers, and at the other shapes
the tools give them, are held against their plain versions by the
``cuda``-marked tests of tests/test_torch_cuda_kernels.py; the
benchmark's roofline metrics (benchmark/run.py) and the sweeps
scripts/torch_sweep_fused.py and scripts/torch_sweep_bw.py time them.

The line before the last is one JSON object of per-kernel results, one
entry per kernel and arithmetic (``launches`` summed over the main paths
of phases 5-14, by path in ``launches_by_path``, where
"parallel-2-processes" counts the two ranks' launches apart and
"milestone-<driver>" each record driver's; 0 for every arithmetic beyond
the tiers, which no tool reaches; ``check_launches`` from the comparisons
of phases 4, 6, 9, 11 and 12; times, bounds and errors for K1 and K2 in
the four tiers, from phase 4, the Viterbi kernel, from phase 9, and the
SVM dual kernel, from phase 11);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import lia_ral_tpu_torch  # noqa: F401  (numerics pin: TF32 off)
from lia_ral_tpu_torch import _build
from lia_ral_tpu_torch.__main__ import main as cli
from lia_ral_tpu_torch.api import RemoteSpkDetClient, SpkDetServer
from lia_ral_tpu_torch.backend import svm as tsvm
from lia_ral_tpu_torch.backend.eval import der, eer
from lia_ral_tpu_torch.backend.ivnorm import (DevSet, apply_efr,
                                              compute_cov_matrices,
                                              compute_lda,
                                              compute_mahalanobis,
                                              compute_wccn, efr_iterations,
                                              length_norm)
from lia_ral_tpu_torch.backend.plda import (PldaModel, plda_em_iteration,
                                            plda_llr, plda_train)
from lia_ral_tpu_torch.backend.scoring import (cosine_scores,
                                               mahalanobis_scores,
                                               two_cov_model, two_cov_scores)
from lia_ral_tpu_torch.config import Config
from lia_ral_tpu_torch.convert import gmm_from_numpy
from lia_ral_tpu_torch.fa.jfa import (JfaModel, JfaStats, estimate_x,
                                      estimate_y, jfa_d_iteration,
                                      jfa_u_iteration, jfa_v_iteration,
                                      jfa_verify_em_llk)
from lia_ral_tpu_torch.fa.stats import BwStats, bw_stats_batch, load_stats
from lia_ral_tpu_torch.fa.tv import (TvModel, approximate_tctc,
                                     eigen_decompose_w, estimate_w,
                                     estimate_w_eigen_decomposition,
                                     estimate_w_ubm_weight, init_t,
                                     norm_t_matrix, orthonormalize_t,
                                     tv_e_step, weighted_cov)
from lia_ral_tpu_torch.gmm import cuda_kernels as ck
from lia_ral_tpu_torch.gmm.em import (TrainCfg, default_stats_fn,
                                      mixture_init, train_model)
from lia_ral_tpu_torch.gmm.kernels import EmStats, em_stats_chunked
from lia_ral_tpu_torch.gmm.map_adapt import MapCfg, adapt_model
from lia_ral_tpu_torch.gmm.model import GmmDiag
from lia_ral_tpu_torch.gmm.scoring import compute_test_llr, stack_gmms
from lia_ral_tpu_torch.io import native as tnative
from lia_ral_tpu_torch.io.features import (read_feature_file,
                                           write_feature_file)
from lia_ral_tpu_torch.io.labels import (frame_mask_to_segments,
                                         read_label_file, write_label_file)
from lia_ral_tpu_torch.io.lists import read_xlist, write_xlist
from lia_ral_tpu_torch.io.matrix import read_matrix_file, write_matrix_file
from lia_ral_tpu_torch.io.nist import read_nist_scores
from lia_ral_tpu_torch.tools.common import (load_features_and_mask,
                                            load_files_batch)
from lia_ral_tpu_torch.parallel import mesh as pmesh
from lia_ral_tpu_torch.parallel.sharding import (sharded_em_stats_2d,
                                                 sharded_estimate_w,
                                                 sharded_jfa_u_iteration,
                                                 sharded_jfa_v_iteration,
                                                 sharded_plda_em_iteration,
                                                 sharded_plda_llr,
                                                 sharded_stats_fn,
                                                 sharded_tv_e_step,
                                                 sharded_tv_e_step_2d)
from lia_ral_tpu_torch.seg import hmm as seg_hmm
from lia_ral_tpu_torch.tools.iv_norm import load_vectors
from lia_ral_tpu_torch.utils.shapes import bucket_len

# the record drivers and the parity and sweep scripts of scripts/
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "scripts"))
import torch_milestone_diar as tdiar  # noqa: E402

K, D, R = 2048, 39, 400
N_SPK, UTT_PER_SPK, T_UTT = 50, 10, 2000
SOURCE = "lia_ral_tpu_torch/csrc/gmm_stats_wgmma.cu"
REPLACES = {"em_stats_fused": "lia_ral_tpu/gmm/pallas_kernels.py:314",
            "bw_stats_fused": "lia_ral_tpu/gmm/pallas_kernels.py:476"}
# tier name → (compute_dtype, stats_pass), as the wrappers take them
TIERS = {"": (None, "x3"), "fastStats": (None, "bf16nx"),
         "fastMath": (torch.bfloat16, "x3"),
         "fastMath+fastStats": (torch.bfloat16, "bf16nx")}


HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12     # H100 SXM peaks


def entry(kernel: str, tier: str) -> str:
    """The launch-count key (and JSON name) of a kernel in a tier."""
    return f"{kernel}[{tier}]" if tier else kernel


def sum_rtol(tier: str) -> float:
    """S/F budget: 2e-3·max for the one-pass bf16 stats of every tier
    but the default (a rounding of p or xa·s flips on f32-level logit
    differences), else the default's 1e-3."""
    return 2e-3 if tier else 1e-3


def n_rtol(tier: str) -> float:
    """Occupancy budget: 1e-4 for the exact sums; fastMath alone takes n
    from a column of its one-pass product and gets that product's 2e-3."""
    return 2e-3 if tier == "fastMath" else 1e-4


def shown(counts) -> dict:
    """The launch counts that are not 0 (the kernels' counts have a key
    for each of K1's and K2's 51 arithmetics)."""
    return {k: v for k, v in counts.items() if v}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name: str, t0: float) -> None:
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def temp_dir(prefix: str) -> str:
    """A work directory that later phases read too; removed at exit."""
    d = tempfile.mkdtemp(prefix=prefix)
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    return d


def check_stats(name, pairs, llk_pair) -> float:
    """pairs: [(label, got, want, rtol)], atol = rtol·max|want| (the JAX
    suite's CPU budgets with the atol scaled to the array).  Returns the
    largest absolute error over the stats arrays."""
    worst = 0.0
    for label, got, want, rtol in pairs:
        scale = float(want.abs().max())
        ok = torch.allclose(got, want, rtol=rtol, atol=rtol * scale)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        print(f"  {name} {label}: max|err| {err:.3e} (scale {scale:.3e})")
        check(ok, f"{name} {label} outside rtol {rtol}, atol {rtol}·max")
    got, want = llk_pair
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    print(f"  {name} llk: max rel err {rel:.3e}")
    check(rel <= 1e-5, f"{name} llk rel err {rel} > 1e-5")
    return worst


def corpus(rng, device, comp_offsets: float = 0.0):
    """Speaker-shifted frames of a 64-component GMM, (S, T, D), with a
    ragged tail masked per utterance.  ``comp_offsets`` > 0 also moves
    each speaker's components by their own offsets of that scale (a
    speaker difference that survives per-file CMVN, unlike the shift)."""
    s = N_SPK * UTT_PER_SPK
    centers = rng.standard_normal((64, D)).astype(np.float32) * 2.0
    shifts = rng.standard_normal((N_SPK, D)).astype(np.float32) * 0.05
    comp = rng.integers(0, 64, (s, T_UTT))
    x = rng.standard_normal((s, T_UTT, D), dtype=np.float32)
    x += centers[comp]
    x += np.repeat(shifts, UTT_PER_SPK, axis=0)[:, None, :]
    lens = T_UTT - rng.integers(0, 200, s)
    mask = (np.arange(T_UTT)[None, :] < lens[:, None]).astype(np.float32)
    if comp_offsets:
        offs = rng.standard_normal((N_SPK, 64, D)).astype(np.float32)
        spk = np.repeat(np.arange(N_SPK), UTT_PER_SPK)[:, None]
        x += comp_offsets * offs[spk, comp]
    return torch.from_numpy(x).to(device), torch.from_numpy(mask).to(device)


def ivector_trials(w):
    """Speaker models from the first half of each speaker's utterances,
    tests from the second half: (models, tests, target mask)."""
    w = w.reshape(N_SPK, UTT_PER_SPK, -1)
    half = UTT_PER_SPK // 2
    models = w[:, :half].mean(1)
    tests = w[:, half:].reshape(-1, w.shape[-1])
    spk = torch.arange(N_SPK, device=w.device)
    target = spk[:, None] == spk.repeat_interleave(UTT_PER_SPK - half)[None]
    return models, tests, target


def run_slice(x, mask, init, tv_t, fused: bool):
    """The main path from a given init GMM and T: returns
    (ubm, bw stats, i-vectors, scores, target mask, meanLLK per EM it)."""
    xf, wf = x.reshape(-1, D), mask.reshape(-1)
    base = default_stats_fn() if fused else em_stats_chunked
    llks = []

    def stats_fn(xx, ww, g):
        st = base(xx, ww, g)
        llks.append(float(st.mean_llk()))
        return st

    # a relaxing floor only widens the feasible set, so EM stays monotone
    cfg = TrainCfg(nb_train_it=3, init_variance_flooring=0.5,
                   final_variance_flooring=0.1, init_variance_ceiling=10.0,
                   final_variance_ceiling=10.0)
    gen = torch.Generator(device=x.device).manual_seed(1)
    ubm = train_model(gen, xf, wf, init, cfg, stats_fn=stats_fn)
    stats_fn(xf, wf, ubm)                       # meanLLK of the final UBM
    bw = bw_stats_batch(x, mask, ubm, use_fused=fused)
    w = estimate_w(bw, TvModel.from_ubm(tv_t, ubm))
    models, tests, target = ivector_trials(w)
    return ubm, bw, w, cosine_scores(models, tests), target, llks


def bound_ms(kernel: str, tier: str, n: int, k: int, d: int,
             utterances: int = 1) -> tuple[float, str]:
    """The least time one call in a tier could take: the larger of the
    bytes (inputs and outputs, each once) over the memory rate and the
    flops of the two products (logits over 2D+1 columns, in fastMath's
    one bf16 pass or three; stats over K1's 2D+1 or K2's D+1 columns, in
    the default tier's three passes or one) over the bf16 rate; n counts
    all frames.  Returns (ms, "bytes" or "operations")."""
    k1 = kernel == "em_stats_fused"
    stat_cols = 2 * d + 1 if k1 else d + 1
    flops = 2 * n * k * ((2 * d + 1) * (1 if "fastMath" in tier else 3)
                         + stat_cols * (1 if tier else 3))
    out_floats = k * (2 * d + 1) + 2 if k1 else utterances * (k * (d + 1) + 1)
    nbytes = 4 * (n * d + n + k * (2 * d + 1) + out_floats)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def check_rounding(name, got, tier_plain, other_plain) -> None:
    """A tier's kernel must sit much closer to its own plain version than
    to another tier's, in mean |error| (a bf16 rounding that flips on an
    f32-level difference moves one element a whole ulp, but rarely)."""
    own = float((got - tier_plain).abs().mean())
    other = float((got - other_plain).abs().mean())
    print(f"  {name}: mean|err| vs its tier {own:.3e}, vs the other tier "
          f"{other:.3e}")
    check(own < 0.5 * other, f"{name} rounds where its plain version rounds")


def run_tiers(xu, mask, ubm, kernels) -> None:
    """Phase 4: K1 and K2 on the slice's frames and UBM against their
    plain versions in every tier, each timed (``timed_pair``) beside
    ``bound_ms``."""
    ck.reset_launch_counts()
    xf, wf = xu.reshape(-1, D), mask.reshape(-1)
    calls = {"em_stats_fused": (ck.em_stats_fused, ck.em_stats_reference,
                                (xf, wf, ubm), ("n", "sum_x", "sum_xx")),
             "bw_stats_fused": (ck.bw_stats_fused, ck.bw_stats_reference,
                                (xu, mask, ubm), ("n", "f"))}
    sums = {}           # entry name → (kernel's, plain version's S or F)
    for tier, (cdt, sp) in TIERS.items():
        kw = {"compute_dtype": cdt, "stats_pass": sp}
        for kname, (fused, plain, args, names) in calls.items():
            ename = entry(kname, tier)

            def run(fn, fn_args=args, fn_kw=kw):
                out = fn(*fn_args, **fn_kw)       # K1's EmStats as a tuple
                return ((out.n, out.sum_x, out.sum_xx, out.llk, out.count)
                        if isinstance(out, EmStats) else out)

            k_ms, p_ms, got, want = timed_pair(lambda: run(fused),
                                               lambda: run(plain))
            label = f"{ename} {tuple(args[0].shape)}"
            err = check_stats(label, [
                (name, g, w, n_rtol(tier) if name == "n" else sum_rtol(tier))
                for name, g, w in zip(names, got, want)],
                (got[len(names)].reshape(-1), want[len(names)].reshape(-1)))
            if kname == "em_stats_fused":
                check(abs(float(got[4]) - float(want[4]))
                      <= 1e-6 * float(want[4]), f"{label} count")
            check(all(torch.equal(a, b) for a, b in zip(run(fused), got)),
                  f"{label} rerun reproduces every digit")
            b_ms, b_by = bound_ms(kname, tier, xf.shape[0], K, D,
                                  utterances=xu.shape[0])
            kernels[ename].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=None,
                                  max_abs_err=err)
            print(f"  {ename}: {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                  f"{b_ms:.3f} ms by {b_by} ({100 * b_ms / k_ms:.1f} %)")
            sums[ename] = (got[1], want[1])
    for kname in calls:
        for tier in TIERS:
            other = entry(kname, "" if tier else "fastStats")
            check_rounding(entry(kname, tier), *sums[entry(kname, tier)],
                           sums[other][1])
    for kname, kv in kernels.items():
        kv["check_launches"] += ck.launch_counts[kname]


def write_corpus(d, x, lens):
    """The slice's utterances as SPRO4 files with .lbl files dropping the
    ragged tail, plus the chain's lists.  Returns the list paths."""
    names = []
    for i in range(x.shape[0]):
        name = f"spk{i // UTT_PER_SPK:02d}_u{i % UTT_PER_SPK}"
        write_feature_file(os.path.join(d, name + ".prm"), x[i], fmt="SPRO4")
        m = np.arange(x.shape[1]) < lens[i]
        write_label_file(os.path.join(d, name + ".lbl"),
                         frame_mask_to_segments(m))
        names.append(name)
    half = UTT_PER_SPK // 2
    models = [(f"spk{s:02d}_model", names[s * UTT_PER_SPK:
                                         s * UTT_PER_SPK + half])
              for s in range(N_SPK)]
    tests = [n for s in range(N_SPK)
             for n in names[s * UTT_PER_SPK + half:(s + 1) * UTT_PER_SPK]]
    lists = {"world": os.path.join(d, "world.lst"),
             "all": os.path.join(d, "all.ndx"),
             "targets": os.path.join(d, "targets.ndx"),
             "trials": os.path.join(d, "trials.ndx")}
    write_xlist(lists["world"], [[n] for n in names])
    write_xlist(lists["all"], [[n] for n in names])
    write_xlist(lists["targets"], [[m] + fs for m, fs in models])
    write_xlist(lists["trials"], [[t] + [m for m, _ in models]
                                  for t in tests])
    return lists


CHAIN = ("TrainWorld", "TotalVariability", "IvExtractor", "IvTest")


@contextlib.contextmanager
def kernel_device_ms(totals):
    """Adds to totals[kernel] the device time of each kernel wrapper call
    the tools make inside the block: CUDA events recorded just before and
    after the call, on the stream the kernels launch on (so the span also
    holds the wrapper's few small parameter ops).  The wrappers are
    wrapped where the tools' modules look them up."""
    from lia_ral_tpu_torch.fa import stats as tstats
    from lia_ral_tpu_torch.gmm import em as tem

    spans = []
    orig = {(tem, "em_stats_fused"): tem.em_stats_fused,
            (tstats, "bw_stats_fused"): tstats.bw_stats_fused,
            (seg_hmm, "viterbi_cuda"): seg_hmm.viterbi_cuda,
            (tsvm, "dual_solve_cuda"): tsvm.dual_solve_cuda}

    def timed(name, fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((name, start, end))
            return out
        return call

    for (mod, name), fn in orig.items():
        setattr(mod, name, timed(name, fn))
    try:
        yield
    finally:
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)
        torch.cuda.synchronize()
        for name, start, end in spans:
            totals[name] = totals.get(name, 0.0) + start.elapsed_time(end)


def run_tool(tool, args, kernel_ms, device="cuda"):
    """One tool through the port's CLI entry, in-process.  Returns its
    wall time (host clock, ending in a device synchronise) and its
    stdout; adds the device ms of the kernel calls inside it to
    kernel_ms (on a CUDA device)."""
    buf = io.StringIO()
    t1 = time.perf_counter()
    timer = (kernel_device_ms(kernel_ms) if device == "cuda"
             else contextlib.nullcontext())
    with contextlib.redirect_stdout(buf), timer:
        rc = cli([tool] + args)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    check(rc == 0, f"{tool} exit code {rc}")
    return wall, buf.getvalue()


def chain_args(d, out, tier, device):
    """The config keys every tool of the i-vector chain takes: the corpus
    under d, models, matrices and vectors under out, the tier's keys."""
    return ["--torchDevice", device, "--featureFilesPath", d + "/",
            "--labelFilesPath", d + "/", "--mixtureFilesPath", out + "/",
            "--matrixFilesPath", out + "/",
            "--saveVectorFilesPath", out + "/",
            "--loadVectorFilesPath", out + "/",
            "--loadFeatureFileFormat", "SPRO4",
            "--labelSelectedFrames", "speech",
            "--fastStats", "true" if "fastStats" in tier else "false",
            "--fastMath", "true" if "fastMath" in tier else "false"]


def run_cli_chain(d, lists, tier, device="cuda", tools=CHAIN):
    """TrainWorld → TotalVariability → IvExtractor → IvTest (or the
    first ``tools``) through the port's CLI entry, with the tier's config
    keys, outputs under d/<tier>.  Returns the meanLLK per EM iteration
    (from TrainWorld's verbose lines), the wall time of each tool (host
    clock, ending in a device synchronise), the device ms of each kernel
    inside the tools and the scores (when IvTest ran)."""
    out = os.path.join(d, tier or "default")
    os.makedirs(out)
    common = chain_args(d, out, tier, device)
    steps = [
        ("TrainWorld", ["--inputFeatureFilename", lists["world"],
                        "--mixtureDistribCount", str(K), "--nbTrainIt", "3",
                        "--baggedFrameProbability", "1.0",
                        "--initVarianceFlooring", "0.5",
                        "--finalVarianceFlooring", "0.1",
                        "--initVarianceCeiling", "10.0",
                        "--finalVarianceCeiling", "10.0",
                        "--randomSeed", "0", "--outputWorldFilename", "wld",
                        "--verbose", "true"]),
        ("TotalVariability", ["--ndxFilename", lists["all"],
                              "--inputWorldFilename", "wld",
                              "--totalVariabilityNumber", str(R),
                              "--nbIt", "2", "--initScale", "0.01",
                              "--totalVariabilityMatrix", "TV",
                              "--meanEstimate", "TVmean",
                              # for phase 7: the eigenDecomposition
                              # matrices and the stats checkpoint
                              "--approximationMode", "eigenDecomposition",
                              "--accsFilename",
                              os.path.join(out, "tv_accs.npz")]),
        ("IvExtractor", ["--ndxFilename", lists["all"],
                         "--inputWorldFilename", "wld",
                         "--totalVariabilityMatrix", "TV",
                         "--meanEstimate", "TVmean", "--ivSolver", "pcg"]),
        ("IvTest", ["--targetIdList", lists["targets"],
                    "--ndxFilename", lists["trials"], "--scoring", "cosine",
                    "--outputFilename", os.path.join(out, "scores.nist")]),
    ]
    walls, llks, kernel_ms = {}, [], {}
    for tool, args in steps:
        if tool not in tools:
            continue
        walls[tool], stdout = run_tool(tool, common + args, kernel_ms,
                                       device)
        if tool == "TrainWorld":
            llks = [float(v) for v in
                    re.findall(r"^it \d+: meanLLK=(\S+)", stdout, re.M)]
    scores = (read_nist_scores(os.path.join(out, "scores.nist"))
              if "IvTest" in tools else None)
    return {"llks": llks, "walls": walls, "kernel_ms": kernel_ms,
            "scores": scores}


# -- phase 6: the GMM-UBM system of configs 1 and 2 ---------------------------

N_TGT = 40              # target speakers; speakers 40-49 are the cohort
MAP_CHECK_CLIENTS, MAP_CHECK_SEGS = 5, 20


def write_gmm_ubm_corpus(d, device):
    """Phase 5's corpus (seed 0) with per-speaker component offsets, as
    500 SPRO4 files of 40 columns: the 39 features and a synthetic
    log-energy that is low on ~20 % of frames (runs of 10-60 frames and
    the ragged tail).  No label files: EnergyDetector writes them.
    Returns the list paths."""
    xu, mask = corpus(np.random.default_rng(0), device, comp_offsets=0.04)
    x, speech = xu.cpu().numpy(), mask.cpu().numpy() > 0
    del xu, mask
    rng = np.random.default_rng(1)
    names = []
    for i in range(x.shape[0]):
        low = ~speech[i]
        for start in rng.integers(0, T_UTT - 60, 8):
            low[start:start + rng.integers(10, 61)] = True
        energy = np.where(low, rng.normal(-3.0, 0.5, T_UTT),
                          rng.normal(4.0, 1.0, T_UTT))
        name = f"spk{i // UTT_PER_SPK:02d}_u{i % UTT_PER_SPK}"
        write_feature_file(os.path.join(d, name + ".prm"),
                           np.c_[x[i], energy].astype(np.float32),
                           fmt="SPRO4")
        names.append(name)
    half = UTT_PER_SPK // 2
    spk = [f"spk{s:02d}" for s in range(N_SPK)]
    tgt, coh = spk[:N_TGT], spk[N_TGT:]

    def tests(group):
        return [f"{s}_u{j}" for s in group for j in range(half, UTT_PER_SPK)]

    lines = {"all": [[n] for n in names],
             "warp": [[n] for n in names[::UTT_PER_SPK]],
             "world": [[f"{s}_u{j}"] for s in spk for j in range(half)],
             "models": [[s] + [f"{s}_u{j}" for j in range(half)]
                        for s in spk],
             "main": [[t] + tgt for t in tests(tgt)],
             "z": [[t] + tgt for t in tests(coh)],
             "t": [[t] + coh for t in tests(tgt)],
             "zt": [[t] + coh for t in tests(coh)]}
    paths = {}
    for key, rows in lines.items():
        paths[key] = os.path.join(d, key + ".ndx")
        write_xlist(paths[key], rows)
    return paths


def gmm_ubm_steps(d, lists):
    """(label, tool, args) of the chain EnergyDetector → NormFeat →
    TrainWorld → TrainTarget → ComputeTest (four lists) → ComputeNorm."""
    raw = ["--loadFeatureFileExtension", ".prm", "--addDefaultLabel", "true",
           "--defaultLabel", "speech"]
    steps = [
        ("EnergyDetector", "EnergyDetector",
         raw + ["--inputFeatureFilename", lists["all"],
                "--featureServerMask", str(D), "--nbTrainIt", "10",
                "--mixtureDistribCount", "3"]),
        ("NormFeat", "NormFeat",
         raw + ["--inputFeatureFilename", lists["all"],
                "--featureServerMask", f"0-{D - 1}", "--mode", "norm",
                "--segmentalMode", "file",
                "--saveFeatureFileExtension", ".norm.prm"]),
        ("NormFeat[featWarp]", "NormFeat",
         raw + ["--inputFeatureFilename", lists["warp"],
                "--featureServerMask", f"0-{D - 1}", "--mode", "featWarp",
                "--saveFeatureFileExtension", ".warp.prm"]),
        ("TrainWorld", "TrainWorld",
         ["--inputFeatureFilename", lists["world"],
          "--mixtureDistribCount", str(K), "--nbTrainIt", "3",
          "--baggedFrameProbability", "1.0", "--initVarianceFlooring", "0.5",
          "--finalVarianceFlooring", "0.1", "--initVarianceCeiling", "10.0",
          "--finalVarianceCeiling", "10.0", "--randomSeed", "0",
          "--outputWorldFilename", "wld"]),
        ("TrainTarget", "TrainTarget",
         ["--targetIdList", lists["models"], "--inputWorldFilename", "wld",
          "--MAPAlgo", "MAPOccDep", "--meanAdapt", "true",
          "--MAPRegFactorMean", "14", "--nbTrainIt", "3"]),
    ]
    for lst in ("main", "z", "t", "zt"):
        steps.append((f"ComputeTest[{lst}]", "ComputeTest",
                      ["--ndxFilename", lists[lst], "--inputWorldFilename",
                       "wld", "--topDistribsCount", "10",
                       "--outputFilename", os.path.join(d, lst + ".nist")]))
    steps.append(("ComputeNorm", "ComputeNorm",
                  ["--normType", "ztnorm",
                   "--testNistFile", os.path.join(d, "main.nist"),
                   "--znormNistFile", os.path.join(d, "z.nist"),
                   "--tnormNistFile", os.path.join(d, "t.nist"),
                   "--ztnormNistFile", os.path.join(d, "zt.nist"),
                   "--outputFileBaseName", os.path.join(d, "ztnorm.nist")]))
    return steps


def check_map_library(d, dev):
    """``adapt_model`` for the first clients from the chain's UBM, once
    through K1 and once through the plain stats path on the card: the
    K1 run reproduces TrainTarget's model files, the plain run's means
    agree within 1e-3·max|μ|, and so do their LLRs on test segments
    (within 1e-3).  Returns (max |Δμ|, max|μ|, max |ΔLLR|)."""
    cfg = Config({"featureFilesPath": d + "/", "labelFilesPath": d + "/",
                  "loadFeatureFileFormat": "SPRO4",
                  "loadFeatureFileExtension": ".norm.prm",
                  "labelSelectedFrames": "speech"})
    world = GmmDiag.load(os.path.join(d, "wld.gmm"), device=dev)
    mcfg = MapCfg(method="MAPOccDep", mean_adapt=True, mean_r=14.0,
                  nb_train_it=3)
    half = UTT_PER_SPK // 2
    fused, plain = [], []
    for s in range(MAP_CHECK_CLIENTS):
        fs, m = load_features_and_mask([f"spk{s:02d}_u{j}"
                                        for j in range(half)], cfg)
        x = torch.as_tensor(fs.data, device=dev)
        w = torch.as_tensor(m, device=dev)
        fused.append(adapt_model(torch.Generator(dev).manual_seed(s), x, w,
                                 world, mcfg))
        plain.append(adapt_model(torch.Generator(dev).manual_seed(s), x, w,
                                 world, mcfg,
                                 stats_fn=ck.em_stats_reference))
        chain = GmmDiag.load(os.path.join(d, f"spk{s:02d}.gmm"), device=dev)
        check(torch.equal(fused[-1].means, chain.means),
              f"adapt_model through K1 reproduces TrainTarget's spk{s:02d}")
    dmu = max(float((a.means - b.means).abs().max())
              for a, b in zip(fused, plain))
    mu_max = max(float(b.means.abs().max()) for b in plain)
    check(dmu <= 1e-3 * mu_max, f"K1 and plain MAP means within 1e-3·max "
          f"(|Δμ| {dmu:.3e}, max|μ| {mu_max:.3e})")
    dllr = 0.0
    for i in range(MAP_CHECK_SEGS):
        seg = f"spk{i // 4:02d}_u{half + i % 4}"
        fs, m = load_features_and_mask([seg], cfg)
        x = torch.as_tensor(fs.data[m > 0], device=dev)
        w = torch.ones(x.shape[0], device=dev)
        a, b = (compute_test_llr(x, w, world, stack_gmms(c), top_k=10)
                for c in (fused, plain))
        dllr = max(dllr, float((a - b).abs().max()))
    check(dllr <= 1e-3, f"K1 and plain MAP clients' LLRs within 1e-3 "
          f"({dllr:.3e})")
    return dmu, mu_max, dllr


def gmm_ubm_args(d, device):
    """The config keys every tool of phases 6 and 8 takes: features,
    labels and models under d, the normalised features as input."""
    return ["--torchDevice", device, "--featureFilesPath", d + "/",
            "--labelFilesPath", d + "/", "--mixtureFilesPath", d + "/",
            "--loadFeatureFileFormat", "SPRO4",
            "--saveFeatureFileFormat", "SPRO4",
            "--loadFeatureFileExtension", ".norm.prm",
            "--labelSelectedFrames", "speech"]


def check_native_reads(label) -> None:
    """The feature files a path read went through the native reader: its
    read counts (from 0 before the path) show native reads and not one
    numpy read of these SPRO4 files."""
    reads = dict(tnative.read_counts)
    print(f"  {label}: feature files read natively {reads['native']}, "
          f"with numpy {reads['numpy']}")
    check(reads["native"] > 0 and reads["numpy"] == 0,
          f"{label}: SPRO4 files read through the native loader ({reads})")


def time_readers(d, names) -> None:
    """Phase 6's 500 raw files through each reader: the native batched
    loader (``load_files_batch``, 64 files a batch) and the numpy reader
    (``read_feature_file(use_native=False)``), host clock, in turns
    (numpy, native, native, numpy; the best of each); the arrays must be
    equal to the digit."""
    cfg = Config({"featureFilesPath": d + "/", "loadFeatureFileFormat":
                  "SPRO4", "loadFeatureFileExtension": ".prm"})
    paths = [os.path.join(d, n + ".prm") for n in names]
    readers = {"native": lambda: load_files_batch(names, cfg),
               "numpy": lambda: [read_feature_file(p, fmt="SPRO4",
                                                   use_native=False).data
                                 for p in paths]}
    times, out = {"native": [], "numpy": []}, {}
    for name in ("numpy", "native", "native", "numpy"):
        t1 = time.perf_counter()
        out[name] = readers[name]()
        times[name].append(time.perf_counter() - t1)
    check(all(a is not None and np.array_equal(a, b)
              for a, b in zip(out["native"], out["numpy"])),
          "the native and numpy readers give the same arrays")
    mb = sum(a.nbytes for a in out["numpy"]) / 1e6
    best = {k: min(v) for k, v in times.items()}
    print(f"  gmm-ubm: {len(paths)} files ({mb:.1f} MB of frames) read in "
          f"{best['native']:.3f} s natively (batches of 64), "
          f"{best['numpy']:.3f} s with numpy (best of 2 each); equal to "
          "the digit")


def run_gmm_ubm(kernels, dev):
    """Phase 6: the GMM-UBM chain at full width on 500 files, K1's launch
    counts and device ms per tool, the scores' checks and EERs, then the
    library-level MAP check.  Returns the work directory, its lists and
    the raw EER in percent (phase 8 goes on from them)."""
    d = temp_dir("lia_chip_smoke_gu_")
    lists = write_gmm_ubm_corpus(d, dev)
    common = gmm_ubm_args(d, dev.type)
    walls, k1_ms, k1_launches = {}, {}, {}
    ck.reset_launch_counts()
    tnative.reset_read_counts()
    for label, tool, args in gmm_ubm_steps(d, lists):
        before = dict(ck.launch_counts)
        kms = {}
        walls[label], _ = run_tool(tool, common + args, kms, dev.type)
        k1_ms[label] = kms.get("em_stats_fused", 0.0)
        k1_launches[label] = (ck.launch_counts["em_stats_fused"]
                              - before["em_stats_fused"])
    launches = dict(ck.launch_counts)
    check_native_reads("gmm-ubm")
    print("  gmm-ubm: tool wall s " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()))
    print("  gmm-ubm: K1 device ms (launches) " + ", ".join(
        f"{k} {k1_ms[k]:.2f} ({k1_launches[k]})" for k in walls
        if k1_launches[k]))
    print(f"  gmm-ubm: launches {shown(launches)}")
    # 500 files x 10 EM iterations; 3 EM iterations; 50 models x 3
    for tool, count in (("EnergyDetector", 5000), ("TrainWorld", 3),
                        ("TrainTarget", 150)):
        check(k1_launches[tool] == count,
              f"K1 launched {count} times by {tool} "
              f"({k1_launches[tool]})")
    check(all(v == 0 for k, v in launches.items()
              if k != "em_stats_fused"),
          "only the default K1 launched on the GMM-UBM path")
    n_trials = {"main": N_TGT * N_TGT * 5, "z": N_TGT * 50,
                "t": 10 * N_TGT * 5, "zt": 500, "ztnorm": N_TGT * N_TGT * 5}
    scores = {}
    for name, n in n_trials.items():
        lines = read_nist_scores(os.path.join(d, name + ".nist"))
        check(len(lines) == n, f"{name} score file has {n} lines "
              f"({len(lines)})")
        sc = np.array([r.score for r in lines])
        check(bool(np.isfinite(sc).all()), f"{name} scores finite")
        scores[name] = (sc, np.array([r.seg.split("_")[0] == r.model
                                      for r in lines]))
    eers = {}
    for name in ("main", "ztnorm"):
        sc, tgt = scores[name]
        check(int(tgt.sum()) == N_TGT * 5, f"{name}: 200 target trials")
        eers[name] = 100 * eer(sc[tgt], sc[~tgt])
        print(f"  gmm-ubm [{name}]: mean target LLR "
              f"{sc[tgt].mean():.4f}, impostor {sc[~tgt].mean():.4f}; "
              f"EER {eers[name]:.2f} % over "
              f"{tgt.sum()} target / {(~tgt).sum()} impostor trials")
        check(sc[tgt].mean() > sc[~tgt].mean(),
              f"{name}: mean target score above mean impostor score")
    warp = [os.path.join(d, n[0] + ".warp.prm")
            for n in read_xlist(lists["warp"])]
    for path in warp:
        y = read_feature_file(path, fmt="SPRO4").data
        check(y.shape == (T_UTT, D) and bool(np.isfinite(y).all()),
              f"featWarp output {path}")
    time_readers(d, [row[0] for row in read_xlist(lists["all"])])
    ck.reset_launch_counts()
    dmu, mu_max, dllr = check_map_library(d, dev)
    print(f"  gmm-ubm: adapt_model K1 vs plain stats on the card, "
          f"{MAP_CHECK_CLIENTS} clients: max|Δμ| {dmu:.3e} (max|μ| "
          f"{mu_max:.3e}); max|ΔLLR| {dllr:.3e} over "
          f"{MAP_CHECK_SEGS} test segments")
    for kname, kv in kernels.items():
        kv["launches_by_path"] = {"cli-ivector": kv["launches"],
                                  "gmm-ubm": launches[kname]}
        kv["launches"] += launches[kname]
        kv["check_launches"] += ck.launch_counts[kname]
    return d, lists, eers["main"]


# -- phase 7: the i-vector back end of configs 3 and 5 ------------------------

PLDA_RANK, LDA_RANK, EFR_ITERATIONS, PLDA_ITERATIONS = 150, 49, 2, 10
LIB_UTTS = 64           # utterances of the card-vs-CPU extraction checks
LIB_TOL = 1e-3          # card vs CPU, of the array's scale


def k2_batches(n_frames, bucket=2048, batch_size=64) -> int:
    """K2 launches that ``bw_stats_bucketed`` makes for files of these
    lengths: one per batch of at most ``batch_size`` files of one padded
    length (a multiple of ``bucket``)."""
    by_len = collections.Counter(bucket_len(n, bucket) for n in n_frames)
    return sum(-(-count // batch_size) for count in by_len.values())


def trial_scores(path, n_trials):
    """(scores, target mask) of a NIST score file whose models and
    segments are named by speaker; checks the count and finiteness."""
    lines = read_nist_scores(path)
    name = os.path.basename(path)
    check(len(lines) == n_trials, f"{name} has {n_trials} lines "
          f"({len(lines)})")
    sc = np.array([r.score for r in lines])
    check(bool(np.isfinite(sc).all()), f"{name} scores finite")
    return sc, np.array([r.model.split("_")[0] == r.seg.split("_")[0]
                         for r in lines])


class Agreement:
    """Card-vs-CPU comparisons of one phase: each prints its error, and
    ``close`` raises if any was outside its tolerance."""

    def __init__(self, phase_name):
        self.phase_name, self.failed = phase_name, []

    def __call__(self, what, card, cpu, tol=LIB_TOL):
        card = card.detach().cpu().double()
        cpu = cpu.detach().cpu().double()
        scale = float(cpu.abs().max())
        err = float((card - cpu).abs().max())
        print(f"  {self.phase_name} lib {what}: max|card - cpu| {err:.3e} "
              f"(scale {scale:.3e})")
        if not (err <= tol * scale and bool(torch.isfinite(card).all())):
            self.failed.append(what)

    def close(self):
        check(not self.failed, f"{self.phase_name}: card and CPU disagree "
              f"beyond tolerance on {self.failed}")


def row_projector(rows):
    """Projector onto the row space, in float64 on the CPU: the same for
    any two bases of one space."""
    p = rows.detach().cpu().double()
    return p.T @ torch.linalg.solve(p @ p.T, p)


def check_backend_library(tv, weights, stats, wv, spk_ids):
    """Every library function of the TV approximations, i-vector
    normalisation, the scorings and PLDA on the card against the same
    function on the CPU, from the same inputs: the chain's T, UBM weights
    and stats (the first LIB_UTTS utterances) and its 500 exact
    i-vectors.  What an eigensolver or QR leaves open (signs, the basis
    inside a repeated eigenvalue) is compared through invariants."""
    agree = Agreement("backend")
    cpu = torch.device("cpu")
    tv_c, w_c = tv.to(cpu), weights.cpu()
    st = BwStats(n=stats.n[:LIB_UTTS], f=stats.f[:LIB_UTTS])
    st_c = st.to(cpu)
    agree("norm_t_matrix", norm_t_matrix(tv), norm_t_matrix(tv_c))
    w_mat = weighted_cov(tv, weights)
    agree("weighted_cov", w_mat, weighted_cov(tv_c, w_c))
    w_in = w_mat.cpu()          # from here both start from the card's W
    agree("estimate_w_ubm_weight", estimate_w_ubm_weight(st, tv, w_mat),
          estimate_w_ubm_weight(st_c, tv_c, w_in))
    q, q_c = eigen_decompose_w(w_mat), eigen_decompose_w(w_in)
    spectra = []
    for name, qq, ww in (("card", q, w_mat), ("CPU", q_c, w_in)):
        lam = qq.T @ ww @ qq
        diag = torch.diagonal(lam)
        agree(f"eigen_decompose_w QᵀWQ diagonal ({name})", lam,
              torch.diag(diag))
        agree(f"eigen_decompose_w QᵀQ = I ({name})", qq.T @ qq,
              torch.eye(qq.shape[0]))
        spectra.append(diag)
    agree("eigen_decompose_w spectrum", *spectra)
    d_mat = approximate_tctc(tv, q)
    agree("approximate_tctc", d_mat, approximate_tctc(tv_c, q.cpu()))
    agree("estimate_w_eigen_decomposition",
          estimate_w_eigen_decomposition(st, tv, d_mat, q),
          estimate_w_eigen_decomposition(st_c, tv_c, d_mat.cpu(), q.cpu()))
    # QR leaves each row's sign open: both results have orthonormal rows
    # of one space, so A·Bᵀ is orthogonal
    ab = (orthonormalize_t(tv).t_flat().cpu().double()
          @ orthonormalize_t(tv_c).t_flat().double().T)
    agree("orthonormalize_t (A·Bᵀ)(A·Bᵀ)ᵀ = I", ab @ ab.T,
          torch.eye(ab.shape[0]))

    dset = DevSet(wv, spk_ids, N_SPK)
    dset_c = dset.to(cpu)
    agree("length_norm", length_norm(wv), length_norm(wv.cpu()))
    for name, a, b in zip(("Sigma", "W", "B"), compute_cov_matrices(dset),
                          compute_cov_matrices(dset_c)):
        agree(f"compute_cov_matrices {name}", a, b)
    for mode in ("sphNorm", "EFR"):
        xn, params = efr_iterations(dset, EFR_ITERATIONS, mode)
        xn_c, _ = efr_iterations(dset_c, EFR_ITERATIONS, mode)
        # whitening rows are eigenvectors: compare the vectors' Gram matrix
        agree(f"efr_iterations[{mode}] Gram", xn @ xn.T, xn_c @ xn_c.T)
    agree("apply_efr", apply_efr(wv, params),
          apply_efr(wv.cpu(), [(m.cpu(), mat.cpu()) for m, mat in params]))
    ndev = dset.replace(vectors=xn)     # the EFR-normalised vectors, on both
    ndev_c = ndev.to(cpu)
    agree("compute_lda row-space projector",
          row_projector(compute_lda(ndev, LDA_RANK)),
          row_projector(compute_lda(ndev_c, LDA_RANK)))
    wccn = compute_wccn(ndev)
    agree("compute_wccn", wccn, compute_wccn(ndev_c))
    maha = compute_mahalanobis(ndev)
    agree("compute_mahalanobis", maha, compute_mahalanobis(ndev_c))
    models, tests, _ = ivector_trials(xn)
    m_c, t_c = models.cpu(), tests.cpu()
    agree("cosine_scores (WCCN)", cosine_scores(models, tests, wccn=wccn),
          cosine_scores(m_c, t_c, wccn=wccn.cpu()))
    agree("mahalanobis_scores", mahalanobis_scores(models, tests, maha),
          mahalanobis_scores(m_c, t_c, maha.cpu()))
    _, w_cov, b_cov = compute_cov_matrices(ndev)
    for name, a, b in zip(("G'", "H'"), two_cov_model(w_cov, b_cov),
                          two_cov_model(w_cov.cpu(), b_cov.cpu())):
        agree(f"two_cov_model {name}", a, b)
    agree("two_cov_scores", two_cov_scores(models, tests, w_cov, b_cov),
          two_cov_scores(m_c, t_c, w_cov.cpu(), b_cov.cpu()))
    mean = xn.mean(0)
    xc = xn - mean
    ns = torch.full((N_SPK,), float(UTT_PER_SPK // 2))
    for rank_g in (0, 20):
        init = PldaModel.init(torch.Generator().manual_seed(3), R, PLDA_RANK,
                              rank_g, data_mean=mean.cpu(),
                              data_cov=(xc.T @ xc / xn.shape[0]).cpu())
        one = plda_em_iteration(init.to(xn.device), ndev)
        one_c = plda_em_iteration(init, ndev_c)
        for f in dataclasses.fields(PldaModel):
            if getattr(one_c, f.name).numel():
                agree(f"plda_em_iteration (rank_g {rank_g}) {f.name}",
                      getattr(one, f.name), getattr(one_c, f.name))
        agree(f"plda_llr (rank_g {rank_g})",
              plda_llr(one, models, ns.to(xn.device), tests),
              plda_llr(one_c, m_c, ns, t_c))
    trained = plda_train(None, ndev, PLDA_RANK, n_iterations=3, init=init)
    trained_c = plda_train(None, ndev_c, PLDA_RANK, n_iterations=3, init=init)
    agree("plda_train (3 iterations) → plda_llr",
          plda_llr(trained, models, ns.to(xn.device), tests),
          plda_llr(trained_c, m_c, ns, t_c))
    agree.close()


def run_backend(d, lists, kernels, dev) -> None:
    """Phase 7: on the default-tier chain of phase 5 (its UBM, T, stats
    checkpoint and 500 exact i-vectors under d/default), the approximate
    extractions, IvNorm → PLDA → IvTest in every scoring, a rerun, and
    the library functions on the card against the CPU."""
    out = os.path.join(d, "default")
    names = [row[0] for row in read_xlist(lists["all"])]
    dev_ndx = os.path.join(d, "dev.ndx")
    write_xlist(dev_ndx, [[f"spk{s:02d}"] + names[s * UTT_PER_SPK:
                                                  (s + 1) * UTT_PER_SPK]
                          for s in range(N_SPK)])
    common = chain_args(d, out, "", dev.type)
    walls, k2_ms = {}, {}

    def tool(label, name, args):
        kms = {}
        walls[label], _ = run_tool(name, common + args, kms, dev.type)
        k2_ms[label] = kms.get("bw_stats_fused", 0.0)

    def subdir(name):
        os.makedirs(os.path.join(out, name), exist_ok=True)
        return os.path.join(out, name) + "/"

    def vectors(path):
        return torch.as_tensor(load_vectors(names, Config(
            {"loadVectorFilesPath": path})), device=dev)

    # the ubmWeight matrix at library level (TotalVariability wrote the
    # eigenDecomposition pair), then both approximate extractions
    gmm = GmmDiag.load(os.path.join(out, "wld.gmm"), device=dev)
    tv = TvModel.load(os.path.join(out, "TV.matx"), gmm)
    tv = tv.replace(ubm_means=torch.as_tensor(
        read_matrix_file(os.path.join(out, "TVmean.matx")).reshape(K, D),
        dtype=torch.float32, device=dev))
    stats, stat_names = load_stats(os.path.join(out, "tv_accs.npz"),
                                   device=dev)
    check(stat_names == names, "the stats checkpoint lists the 500 sessions")
    w_mat = weighted_cov(tv, gmm.weights)
    write_matrix_file(os.path.join(out, "TV_weightedCov.matx"),
                      w_mat.cpu().numpy().astype(np.float64))
    extract = ["--ndxFilename", lists["all"], "--inputWorldFilename", "wld",
               "--totalVariabilityMatrix", "TV", "--meanEstimate", "TVmean"]
    ck.reset_launch_counts()
    tool("IvExtractor[ubmWeight]", "IvExtractor", extract + [
        "--ivExtractionMode", "ubmWeight", "--loadAccs", "true",
        "--accsFilename", os.path.join(out, "tv_accs.npz"),
        "--saveVectorFilesPath", subdir("ubw")])
    check(not any(ck.launch_counts.values()),
          "IvExtractor with loadAccs launches no kernel")
    tool("IvExtractor[eigenDecomposition]", "IvExtractor", extract + [
        "--ivExtractionMode", "eigenDecomposition",
        "--saveVectorFilesPath", subdir("eig")])
    exact = vectors(out + "/")
    for mode in ("ubw", "eig"):
        approx = vectors(subdir(mode))
        check(bool(torch.isfinite(approx).all()), f"{mode} i-vectors finite")
        cos = torch.nn.functional.cosine_similarity(approx, exact, dim=-1)
        print(f"  backend: {mode} i-vectors against the exact ones: mean "
              f"cosine {float(cos.mean()):.4f} (min {float(cos.min()):.4f})")
    lib = estimate_w_ubm_weight(stats, tv, w_mat)
    dw = float((lib - vectors(subdir("ubw"))).abs().max())
    check(dw <= 1e-5 * float(lib.abs().max()), "estimate_w_ubm_weight at "
          f"library level gives the tool's vectors (max|diff| {dw:.3e})")

    # IvNorm (EFR) → PLDA → IvTest in every scoring.  The corpus has no
    # separate dev set: all 500 i-vectors (50 speakers x 10 sessions), the
    # trial sessions included, estimate every back-end matrix
    trial = ["--targetIdList", lists["targets"], "--ndxFilename",
             lists["trials"], "--backgroundNdxFilename", dev_ndx]
    efr = ["--ivNormIterationNb", str(EFR_ITERATIONS), "--ivNormEfrMode",
           "EFR"]

    def norm_plda_test(name, tag=""):
        """IvNorm → PLDA → IvTest (plda) with every output under
        out/<name>; returns the score file."""
        sub = subdir(name)
        tool(f"IvNorm{tag}", "IvNorm", efr + [
            "--backgroundNdxFilename", dev_ndx, "--inputVectorFilename",
            lists["all"], "--saveVectorFilesPath", sub,
            "--matrixFilesPath", sub])
        tool(f"PLDA{tag}", "PLDA", [
            "--backgroundNdxFilename", dev_ndx, "--loadVectorFilesPath", sub,
            "--pldaEigenVoiceNumber", str(PLDA_RANK), "--pldaNbIt",
            str(PLDA_ITERATIONS), "--matrixFilesPath", sub,
            "--pldaModelFilename", sub + "plda.npz"])
        tool(f"IvTest[plda]{tag}", "IvTest", trial + [
            "--scoring", "plda", "--loadVectorFilesPath", sub,
            "--pldaModelFilename", sub + "plda.npz",
            "--outputFilename", sub + "plda.nist"])
        return sub + "plda.nist"

    plda_file = norm_plda_test("norm")
    norm = subdir("norm")
    normed = vectors(norm)
    dn = float((torch.linalg.norm(normed, dim=-1) - 1.0).abs().max())
    check(dn <= 1e-5, f"IvNorm's vectors have unit norm ({dn:.3e})")
    params = [tuple(torch.as_tensor(read_matrix_file(
        f"{norm}EFR_ivNormEfr{part}_it{it}.matx"), dtype=torch.float32,
        device=dev) for part in ("Mean", "Matrix"))
        for it in range(EFR_ITERATIONS)]
    de = float((apply_efr(exact, [(m.ravel(), mat) for m, mat in params])
                - normed).abs().max())
    check(de <= 1e-5, "IvNorm's vectors are apply_efr of its saved "
          f"per-iteration files ({de:.3e})")
    modes = {
        "cosine+WCCN": (norm, ["--scoring", "cosine", "--wccn", "true",
                               "--wccnMatrix", "wccn"]),
        "mahalanobis": (norm, ["--scoring", "mahalanobis",
                               "--mahalanobisMatrix", "mahalanobis"]),
        "2cov": (norm, ["--scoring", "2cov"]),
        # LDA is estimated inside IvTest, on its own EFR of the raw vectors
        "LDA": (out + "/", efr + ["--scoring", "cosine", "--ivNorm", "true",
                                  "--ldaRank", str(LDA_RANK), "--ldaMatrix",
                                  "lda", "--matrixFilesPath", subdir("lda")]),
    }
    files = {"plda": plda_file}
    for mode, (vec_dir, args) in modes.items():
        files[mode] = os.path.join(out, f"scores_{mode}.nist")
        tool(f"IvTest[{mode}]", "IvTest", trial + args + [
            "--loadVectorFilesPath", vec_dir, "--outputFilename",
            files[mode]])
    lda = read_matrix_file(os.path.join(out, "lda", "lda.matx"))
    check(lda.shape == (LDA_RANK, R) and bool(np.isfinite(lda).all()),
          "IvTest wrote the LDA matrix")
    n_trials = N_SPK * N_SPK * (UTT_PER_SPK // 2)
    print(f"  backend: dev set = the {len(names)} i-vectors of the trials' "
          f"own sessions (no separate dev set); PLDA rank {PLDA_RANK} on "
          f"{N_SPK} speakers")
    for mode, path in files.items():
        sc, tgt = trial_scores(path, n_trials)
        print(f"  backend [{mode}]: mean target score {sc[tgt].mean():.4f}, "
              f"impostor {sc[~tgt].mean():.4f}; EER "
              f"{100 * eer(sc[tgt], sc[~tgt]):.2f} % over {tgt.sum()} "
              f"target / {(~tgt).sum()} impostor trials")
        if mode in ("cosine+WCCN", "plda", "2cov"):
            check(sc[tgt].mean() > sc[~tgt].mean(),
                  f"{mode}: mean target score above mean impostor score")
    rerun = norm_plda_test("rerun", " (rerun)")
    with open(plda_file, "rb") as f1, open(rerun, "rb") as f2:
        check(f1.read() == f2.read(), "a rerun of IvNorm → PLDA → "
              "IvTest (plda) reproduces every score to the digit")
    # the path's launches: the eigenDecomposition IvExtractor's stats
    launches = dict(ck.launch_counts)
    want = k2_batches([T_UTT] * len(names))
    check(launches["bw_stats_fused"] == want and sum(launches.values())
          == want, f"K2 launched {want} times on the back-end path, by the "
          "eigenDecomposition IvExtractor, and nothing else "
          f"({shown(launches)})")
    print("  backend: tool wall s " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()))
    print("  backend: K2 device ms " + ", ".join(
        f"{k} {v:.2f}" for k, v in k2_ms.items() if v)
        + f"; launches {shown(launches)}")
    for kname, kv in kernels.items():
        kv["launches_by_path"]["backend"] = launches[kname]
        kv["launches"] += launches[kname]
    spk_ids = torch.arange(N_SPK, device=dev).repeat_interleave(UTT_PER_SPK)
    t1 = time.perf_counter()
    check_backend_library(tv, gmm.weights, stats, exact, spk_ids)
    print(f"  backend: library functions card vs CPU in "
          f"{time.perf_counter() - t1:.1f} s")


# -- phase 8: the JFA system of config 4 -------------------------------------

JFA_RV, JFA_RU, JFA_ITERATIONS = 300, 100, 2
LFA_SEGS, LFA_TAU = 20, 16.0


def run_jfa(d, lists, raw_eer, kernels, dev) -> None:
    """Phase 8: on phase 6's normalised features, labels, world model
    and MAP clients under d: ComputeJFAStats → EigenVoice → EigenChannel
    → EstimateDMatrix → TrainTarget (JFA) → ComputeTest (jfa), then the
    LFA tools; K2's launch counts per tool, the V-iteration likelihoods
    and the D update at library level."""
    torch.cuda.reset_peak_memory_stats()
    common = gmm_ubm_args(d, dev.type) + ["--matrixFilesPath", d + "/",
                                          "--inputWorldFilename", "wld"]
    accs = os.path.join(d, "jfa_accs.npz")
    load = ["--loadAccs", "true", "--accsFilename", accs, "--nbIt",
            str(JFA_ITERATIONS)]
    models = read_xlist(lists["models"])
    targets = os.path.join(d, "jfa_targets.ndx")
    write_xlist(targets, models[:N_TGT])
    lfa_ndx = os.path.join(d, "lfa.ndx")
    write_xlist(lfa_ndx, read_xlist(lists["main"])[:LFA_SEGS])
    world = GmmDiag.load(os.path.join(d, "wld.gmm"), device=dev)
    # EstimateDMatrix starts from D = 0, a fixed point of its update (z =
    # D·Σ⁻¹·F̃/(τ + N·D²Σ⁻¹) = 0): it writes zeros.  TrainTarget enrols
    # with the relevance-MAP diagonal D = sqrt(Σ/τ) instead
    d_map = torch.sqrt(1.0 / (world.cov_inv * LFA_TAU))
    write_matrix_file(os.path.join(d, "Dmap.matx"),
                      d_map.reshape(1, -1).cpu().numpy().astype(np.float64))
    # ComputeTest reads the world with the clients' extension
    shutil.copy(os.path.join(d, "wld.gmm"), os.path.join(d, "wld.jfa.gmm"))
    steps = [
        ("ComputeJFAStats", "ComputeJFAStats",
         ["--ndxFilename", lists["models"], "--accsFilename", accs]),
        ("EigenVoice", "EigenVoice",
         load + ["--eigenVoiceNumber", str(JFA_RV), "--eigenVoiceMatrix",
                 "EV"]),
        ("EigenChannel", "EigenChannel",
         load + ["--eigenVoiceMatrix", "EV", "--eigenChannelNumber",
                 str(JFA_RU), "--eigenChannelMatrix", "EC"]),
        ("EstimateDMatrix", "EstimateDMatrix",
         load + ["--eigenVoiceMatrix", "EV", "--eigenChannelMatrix", "EC",
                 "--DMatrix", "D"]),
        ("TrainTarget[JFA]", "TrainTarget",
         ["--targetIdList", targets, "--channelCompensation", "JFA",
          "--eigenVoiceMatrix", "EV", "--eigenChannelMatrix", "EC",
          "--DMatrix", "Dmap", "--saveMixtureFileExtension", ".jfa.gmm"]),
        ("ComputeTest[jfa]", "ComputeTest",
         ["--computeTestMode", "jfa", "--ndxFilename", lists["main"],
          "--loadMixtureFileExtension", ".jfa.gmm", "--eigenVoiceMatrix",
          "EV", "--eigenChannelMatrix", "EC", "--topDistribsCount", "10",
          "--outputFilename", os.path.join(d, "jfa.nist")]),
        ("NormFeat[featLFA]", "NormFeat",
         ["--inputFeatureFilename", lists["warp"], "--mode", "featLFA",
          "--eigenChannelMatrix", "EC", "--regulationFactor", str(LFA_TAU),
          "--saveFeatureFileExtension", ".lfa.prm"]),
        ("ComputeTest[lfa]", "ComputeTest",
         ["--computeTestMode", "lfa", "--ndxFilename", lfa_ndx,
          "--eigenChannelMatrix", "EC", "--regulationFactor", str(LFA_TAU),
          "--topDistribsCount", "10",
          "--outputFilename", os.path.join(d, "lfa.nist")]),
    ]
    walls, k2_ms, k2_launches = {}, {}, {}
    ck.reset_launch_counts()
    for label, tool, args in steps:
        before = ck.launch_counts["bw_stats_fused"]
        kms = {}
        walls[label], _ = run_tool(tool, common + args, kms, dev.type)
        k2_ms[label] = kms.get("bw_stats_fused", 0.0)
        k2_launches[label] = ck.launch_counts["bw_stats_fused"] - before
    launches = dict(ck.launch_counts)
    print("  jfa: tool wall s " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()))
    print("  jfa: K2 device ms (launches) " + ", ".join(
        f"{k} {k2_ms[k]:.2f} ({k2_launches[k]})" for k in walls
        if k2_launches[k]))
    print(f"  jfa: launches {shown(launches)}")
    n_segs = len(read_xlist(lists["main"]))
    per_seg = {mode: 1e3 * walls[f"ComputeTest[{mode}]"] / n
               for mode, n in (("jfa", n_segs), ("lfa", LFA_SEGS))}
    print(f"  jfa: ComputeTest[jfa] {per_seg['jfa']:.1f} ms per test segment "
          f"({n_segs} segments x {N_TGT} clients), ComputeTest[lfa] "
          f"{per_seg['lfa']:.1f} ms ({LFA_SEGS} segments)")

    def frames(name):
        return read_feature_file(os.path.join(d, name + ".norm.prm"),
                                 fmt="SPRO4").data.shape[0]

    expected = {"ComputeJFAStats": k2_batches(
        [frames(f) for row in models for f in row[1:]]),
        "TrainTarget[JFA]": k2_batches(
        [frames(f) for row in models[:N_TGT] for f in row[1:]])}
    for label in walls:
        count = expected.get(label, 0)
        check(k2_launches[label] == count, f"K2 launched {count} times by "
              f"{label} ({k2_launches[label]})")
    check(sum(launches.values()) == sum(expected.values()),
          "only the default K2 launched on the JFA path")

    # V and U: finite and moved off the tools' init (seed 0, drawn on the
    # card as the tools draw it)
    def subspace(name, rank):
        mat = read_matrix_file(os.path.join(d, name + ".matx"))
        check(mat.shape == (rank, K * D) and bool(np.isfinite(mat).all()),
              f"{name} is a finite ({rank}, K·D) matrix")
        return torch.as_tensor(mat.reshape(rank, K, D), dtype=torch.float32,
                               device=dev)

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    v, u = subspace("EV", JFA_RV), subspace("EC", JFA_RU)
    v0 = JfaModel.init(seeded(), JFA_RV, 1, world).v
    u0 = JfaModel.init(seeded(), 1, JFA_RU, world).u
    for name, got, init in (("V", v, v0), ("U", u, u0)):
        moved = float((got - init).abs().max())
        print(f"  jfa: {name} max|·| {float(got.abs().max()):.3e}, moved "
              f"{moved:.3e} from its init (max|init| "
              f"{float(init.abs().max()):.3e})")
        check(moved > 0, f"{name} changed from its init")
    check(not subspace("D", 1).any(), "EstimateDMatrix from D = 0 writes "
          "zeros (the update's fixed point, in the JAX tool too)")

    # the V iterations at library level from the tool's init: its V, and
    # the EM likelihood of 2 sessions under m + V·y
    sess, _ = load_stats(accs, device=dev)
    stats = JfaStats.from_sessions(sess, np.load(accs + ".spk.npy"), N_SPK)
    cfg = Config({"featureFilesPath": d + "/", "labelFilesPath": d + "/",
                  "loadFeatureFileFormat": "SPRO4",
                  "loadFeatureFileExtension": ".norm.prm",
                  "labelSelectedFrames": "speech"})
    loaded = [load_features_and_mask([name], cfg) for name in models[0][1:3]]
    xf = torch.stack([torch.as_tensor(fs.data, device=dev)
                      for fs, _ in loaded])
    mask = torch.stack([torch.as_tensor(m, device=dev) for _, m in loaded])
    model = JfaModel.init(seeded(), JFA_RV, 1, world)
    x0 = torch.zeros((stats.sess.n.shape[0], 1), device=dev)
    z0 = torch.zeros((N_SPK, K, D), device=dev)
    llks = []
    for it in range(JFA_ITERATIONS + 1):
        y, _ = estimate_y(stats, model, x0, z0)
        llks.append(jfa_verify_em_llk(xf, mask, stats, model, world.weights,
                                      y, x0, z0, max_sessions=2))
        if it < JFA_ITERATIONS:
            model, _ = jfa_v_iteration(stats, model, x0, z0)
    dv = float((model.v - v).abs().max())
    print("  jfa: LLK of 2 sessions (sum of their mean frame LLKs) before "
          "and after each V iteration: " + ", ".join(f"{v_:.5f}"
                                                     for v_ in llks)
          + f"; library V against EigenVoice's file max|diff| {dv:.3e}")
    check(dv <= 1e-4 * float(v.abs().max()), "the library's V iterations "
          "give EigenVoice's matrix")
    for a, b in zip(llks, llks[1:]):     # 1e-3 nats/frame for each session
        check(b >= a - 2e-3, f"JFA LLK decreased over a V iteration: {llks}")
    # the D update from a non-zero D moves it and stays finite
    full = JfaModel(v=v, u=u, d=d_map, ubm_means=world.means,
                    ubm_inv_var=world.cov_inv)
    del model, v0, u0
    y, _ = estimate_y(stats, full, torch.zeros(
        (stats.sess.n.shape[0], JFA_RU), device=dev), z0)
    x, _ = estimate_x(stats, full, y, z0)
    d_new = jfa_d_iteration(stats, full, y, x, tau=LFA_TAU)[0].d
    moved = float((d_new - d_map).abs().max())
    print(f"  jfa: jfa_d_iteration from D = sqrt(Σ/τ): max|D| "
          f"{float(d_new.abs().max()):.3e}, moved {moved:.3e}")
    check(bool(torch.isfinite(d_new).all()) and moved > 0,
          "the D update from a non-zero D is finite and moves D")

    sc, tgt = trial_scores(os.path.join(d, "jfa.nist"), N_TGT * N_TGT * 5)
    jfa_eer = 100 * eer(sc[tgt], sc[~tgt])
    print(f"  jfa [jfa]: mean target LLR {sc[tgt].mean():.4f}, impostor "
          f"{sc[~tgt].mean():.4f}; EER {jfa_eer:.2f} % (phase 6's raw MAP "
          f"EER on the same trials {raw_eer:.2f} %; the corpus has no "
          "channel variation)")
    check(sc[tgt].mean() > sc[~tgt].mean(),
          "jfa: mean target score above mean impostor score")
    sc, tgt = trial_scores(os.path.join(d, "lfa.nist"), LFA_SEGS * N_TGT)
    print(f"  jfa [lfa]: mean target LLR {sc[tgt].mean():.4f}, impostor "
          f"{sc[~tgt].mean():.4f} over {LFA_SEGS} segments")
    changed = 0.0
    lfa_files = read_xlist(lists["warp"])
    for row in lfa_files:
        y_ = read_feature_file(os.path.join(d, row[0] + ".lfa.prm"),
                               fmt="SPRO4").data
        x_ = read_feature_file(os.path.join(d, row[0] + ".norm.prm"),
                               fmt="SPRO4").data
        check(y_.shape == x_.shape and bool(np.isfinite(y_).all()),
              f"featLFA output of {row[0]}")
        changed = max(changed, float(np.abs(y_ - x_).max()))
    check(changed > 0, "featLFA removed a channel offset")
    print(f"  jfa: featLFA on {len(lfa_files)} files moved frames by at most "
          f"{changed:.3e}; peak device memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for kname, kv in kernels.items():
        kv["launches_by_path"]["jfa"] = launches[kname]
        kv["launches"] += launches[kname]


# -- phase 9: diarization at the milestone shape ------------------------------

DIAR_SPK, DIAR_FRAME = tdiar.N_SPK, tdiar.FRAME
DIAR_K_EVENT, DIAR_K_WORLD = tdiar.K_EVENT, tdiar.K_UBM
DIAR_COLLAR = tdiar.TOL_FRAMES
DIAR_MAX_SPEAKERS, DIAR_DECODE_IT, DIAR_RESEG_IT = 5, 3, 4
# the launch-count keys of K1 on the diarization path: its entry (the
# models TrainWorld trains) and its grouped entry (the state adaptations)
K1_KEYS = ("em_stats_fused", "em_stats_fused_grouped")
# DER limit (full timeline, collar 0): the CPU run of the same corpus
# through the port, from the same numpy-made inits, gave 4.24 % after
# Segmentation and 4.72 % after ReSegmentation.  The E-HMM seeds each new
# speaker at an argmin over windows, so an f32-level difference in the
# card's sums can send it down another trajectory (another world model of
# the same corpus gave 6.80 %): the limit leaves room for that
DIAR_DER_LIMIT = 0.08
DIAR_SAD_LIMIT = 0.01
VITERBI_SOURCE = "lia_ral_tpu_torch/csrc/viterbi.cu"
F32_FLOPS_PER_S = 67e12                        # H100 SXM, CUDA cores


def viterbi_bound(n: int, s: int) -> tuple[float, str]:
    """(bound ms, by): the larger of the bytes (emissions and transitions
    in, the path out, each once) over the memory rate and the 2·N·S² adds
    and compares over the f32 rate.  Both are microseconds: what limits
    any Viterbi is its chain of N dependent steps, which this bound does
    not see (``viterbi_chain_cycles``)."""
    t_bytes = (4 * n * s + 4 * s * s + 8 * n) / HBM_BYTES_PER_S
    t_ops = 2 * n * s * s / F32_FLOPS_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# latencies on the H100, in SM cycles, of the instructions on the chain
# of a Viterbi step (as measured, PERF.md section 6: a warp's
# exchange through shared memory, STS + __syncwarp + LDS, 28; LDS 29;
# FADD and FMNMX 4)
EXCHANGE_CYCLES, ALU_CYCLES = 29, 4


def viterbi_chain_cycles(s: int) -> int:
    """Cycles of one step's dependent chain in csrc/viterbi.cu: the
    deltas' exchange, an add, ceil(log2 SP) levels of fmaxf over the
    instance's SP candidates, the emission's add."""
    sp = seg_hmm.instance(s)
    return EXCHANGE_CYCLES + ALU_CYCLES * (2 + math.ceil(math.log2(sp)))


def sm_clock_hz() -> float:
    """The SM clock nvidia-smi reads now (right after a timed loop the
    card is still at its working clock)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


def check_viterbi(dev):
    """The Viterbi kernel against the plain loop, path for path, at the
    diarization shape, at the smallest shape, with inactive states, on a
    60,000-frame decode, at every kernel instance (S = 1, 2, 3, 5, 8, 9,
    12, 16, 17, 20, 24, 28, 32) at the edges of the 64-row units and of
    the tail's 256 threads; timed at N=30,000 and N=60,000 (S=5) and at
    the diarization cell's shape (N = 300,000, S = 24, 13 states active,
    log densities), each timed decode held against the plain loop, with
    ns and SM cycles a step beside the chain's estimate.  Returns the
    kernels-line entry (without the launch counts)."""
    rng = np.random.default_rng(7)

    def case(n, s, active=None, density=False):
        # density: negative, as the diarization's log densities are
        em = (rng.standard_normal((n, s)) * 3).astype(np.float32)
        if density:
            em = -np.abs(em) - 20
        t = np.full((s, s), 1e-30)
        a = s if active is None else active
        t[:a, :a] = seg_hmm.compute_transitions(a)
        em[:, a:] = -1e30
        return (torch.from_numpy(em).to(dev),
                torch.log(torch.from_numpy(t.astype(np.float32))).to(dev))

    shapes = [(30000, 5, None), (1, 1, None), (30000, 5, 3), (2, 32, None),
              (1025, 2, None), (256 * 64 + 1, 5, None),
              (256 * 64 + 2, 5, None)]
    shapes += [(n, s, None)
               for s in (1, 2, 3, 5, 8, 9, 12, 16, 17, 20, 24, 28, 32)
               for n in (64, 65, 66, 257)]
    mismatches = 0
    for n, s, active in shapes:
        em, lt = case(n, s, active)
        got = seg_hmm.viterbi_cuda(em, lt)
        torch.cuda.synchronize()
        want = seg_hmm.viterbi_reference(em.cpu(), lt.cpu()).to(dev)
        bad = int((got != want).sum())
        if bad or n >= 1000:
            print(f"  viterbi N={n} S={s} active={active or s}: "
                  f"{bad} of {n} states differ from the plain loop")
        mismatches += bad
        if active:
            check(int(got.max()) < active, "viterbi stays in active states")
    print(f"  viterbi: {len(shapes)} shapes against the plain loop, "
          f"{mismatches} states differ")
    check(mismatches == 0, "viterbi_cuda equals the plain loop exactly")
    times = {}
    for n, s, active in ((30000, 5, None), (60000, 5, None),
                         (300000, 24, 13)):
        em, lt = case(n, s, active, density=active is not None)
        if n == 30000:
            k_ms, p_ms, got, want = timed_pair(
                lambda: seg_hmm.viterbi_cuda(em, lt),
                lambda: seg_hmm.viterbi_reference(em, lt))
        else:                  # the long decodes: the kernel alone timed
            seg_hmm.viterbi_cuda(em, lt)
            k_ms = statistics.median(
                cuda_ms(lambda: seg_hmm.viterbi_cuda(em, lt))
                for _ in range(3))
            p_ms = None
            got = seg_hmm.viterbi_cuda(em, lt)
            want = seg_hmm.viterbi_reference(em.cpu(), lt.cpu()).to(dev)
        hz = sm_clock_hz()
        check(torch.equal(got, want), f"viterbi N={n} S={s} timed paths equal")
        if active:
            check(int(got.max()) < active, "viterbi stays in active states")
        b_ms, b_by = viterbi_bound(n, s)
        chain = viterbi_chain_cycles(s)
        chain_ms = 1e3 * chain * (n - 1) / hz
        times[(n, s)] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                         "bound_by": b_by,
                         "cycles_per_step": 1e-3 * k_ms * hz / n}
        print(f"  viterbi N={n} S={s}: kernel {k_ms:.3f} ms "
              f"({1e6 * k_ms / n:.1f} ns, {1e-3 * k_ms * hz / n:.1f} SM "
              f"cycles a step at {hz / 1e6:.0f} MHz), plain loop "
              + (f"{p_ms:.1f} ms" if p_ms else "not timed")
              + f", bound {b_ms:.2e} ms by {b_by}, chain "
              f"estimate {chain} cycles a step = {chain_ms:.3f} ms")
    return {"name": "viterbi", "route": "cuda", "source": VITERBI_SOURCE,
            "replaces": "lia_ral_tpu/seg/hmm.py:71 (lax.scan; no TPU "
                        "kernel)",
            "max_abs_err": float(mismatches), **times[(30000, 5)],
            "library_ms": None,
            "shapes": {"long_decode": times[(60000, 5)],
                       "diar_cell": times[(300000, 24)]}}


def run_diarization(kernels, dev):
    """Phase 9: the four LIA_SpkSeg tools at the milestone shape, K1's
    and the Viterbi kernel's launches and device ms per tool, SAD error,
    speakers found, DERs, a rerun; then the Viterbi kernel's own checks
    and times.  Returns the work directory and the speech frame count of
    its label files (phase 11 reads them)."""
    d = temp_dir("lia_chip_smoke_diar_")
    x, ref, boots = tdiar.gen_conversation(np.random.default_rng(20260823))
    n = ref.shape[0]
    write_feature_file(os.path.join(d, "conv.prm"), x, fmt="SPRO4")
    for nm, bx in boots.items():
        write_feature_file(os.path.join(d, nm + ".prm"), bx, fmt="SPRO4")
    common = ["--torchDevice", dev.type, "--featureFilesPath", d + "/",
              "--mixtureFilesPath", d + "/", "--labelFilesPath", d + "/",
              "--lstPath", d + "/", "--loadFeatureFileFormat", "SPRO4",
              "--loadFeatureFileExtension", ".prm",
              "--addDefaultLabel", "true", "--defaultLabel", "speech",
              "--labelSelectedFrames", "speech"]
    train = ["--nbTrainIt", "4", "--baggedFrameProbability", "1.0",
             "--baggedFrameProbabilityInit", "1.0",
             "--initVarianceFlooring", "1.0", "--initVarianceCeiling", "10.0",
             "--finalVarianceFlooring", "0.5", "--finalVarianceCeiling",
             "5.0", "--randomSeed", "0"]
    walls, k_ms, launches = {}, {}, {}

    def write_init(name, frames, k):
        """An init model made with numpy (the diarization driver's: k
        frames as means, the frames' variance), so that the card and a CPU
        rehearsal train from the same start: torch's CPU and CUDA
        generators differ."""
        tdiar.init_gmm(frames, k).save(os.path.join(d, name + ".gmm"))

    def k1_launches():
        # K1's entry and its grouped entry (the state adaptations)
        return sum(ck.launch_counts[k] for k in K1_KEYS)

    def run(label, tool, args):
        k1, vit = k1_launches(), seg_hmm.launch_counts["viterbi"]
        kms = {}
        walls[label], _ = run_tool(tool, common + args, kms, dev.type)
        k_ms[label] = (kms.get("em_stats_fused", 0.0),
                       kms.get("viterbi_cuda", 0.0))
        launches[label] = (k1_launches() - k1,
                           seg_hmm.launch_counts["viterbi"] - vit)

    ck.reset_launch_counts()
    seg_hmm.reset_launch_counts()
    for ev in ("speech", "silence", "music"):
        write_init("init_" + ev, boots["boot_" + ev], DIAR_K_EVENT)
        run(f"TrainWorld[{ev}]", "TrainWorld",
            train + ["--mixtureDistribCount", str(DIAR_K_EVENT),
                     "--inputFeatureFilename", "boot_" + ev,
                     "--inputWorldFilename", "init_" + ev,
                     "--outputWorldFilename", "evt_" + ev])
    run("AcousticSegmentation", "AcousticSegmentation",
        ["--inputFeatureFilename", "conv", "--acousticModels",
         "evt_speech,evt_silence,evt_music", "--minimumDuration", "30",
         "--saveLabelFileExtension", ".sad.lbl"])
    sad = np.zeros(n, bool)
    for s in read_label_file(os.path.join(d, "conv.sad.lbl")):
        if s.label == "evt_speech":
            sad[int(round(s.begin / DIAR_FRAME)):
                min(int(round(s.end / DIAR_FRAME)), n)] = True
    ref_speech = ref >= 0
    sad_err = float((sad != ref_speech).mean())
    sp_idx = np.nonzero(sad)[0]
    write_feature_file(os.path.join(d, "convsp.prm"), x[sp_idx], fmt="SPRO4")
    write_init("init_wld", x[sp_idx], DIAR_K_WORLD)
    run("TrainWorld[world]", "TrainWorld",
        train + ["--mixtureDistribCount", str(DIAR_K_WORLD),
                 "--inputFeatureFilename", "convsp",
                 "--inputWorldFilename", "init_wld",
                 "--outputWorldFilename", "wld"])
    run("TurnDetection", "TurnDetection",
        ["--inputFeatureFilename", "convsp", "--windowDuration", "1.0",
         "--alpha", "0.7", "--saveLabelFileExtension", ".turn.lbl"])
    seg_args = ["--inputFeatureFilename", "convsp", "--inputWorldFilename",
                "wld", "--maxSpeakers", str(DIAR_MAX_SPEAKERS),
                "--nbDecodeIt", str(DIAR_DECODE_IT),
                "--MAPRegFactorMean", "3.0"]
    run("Segmentation", "Segmentation",
        seg_args + ["--saveLabelFileExtension", ".seg.lbl"])
    run("ReSegmentation", "ReSegmentation",
        ["--inputFeatureFilename", "convsp", "--inputWorldFilename", "wld",
         "--MAPRegFactorMean", "3.0", "--nbTrainIt", str(DIAR_RESEG_IT),
         "--loadLabelFileExtension", ".seg.lbl",
         "--saveLabelFileExtension", ".reseg.lbl"])
    main_k1 = {k: ck.launch_counts[k] for k in K1_KEYS}
    main_vit = seg_hmm.launch_counts["viterbi"]
    other = {k: v for k, v in ck.launch_counts.items()
             if k not in K1_KEYS and v}
    check(not other, f"only the default K1 on the diarization path {other}")

    print("  diar: tool wall s " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()))
    print("  diar: K1 launches (device ms) / Viterbi launches (device ms) "
          + ", ".join(f"{k} {launches[k][0]} ({k_ms[k][0]:.2f}) / "
                      f"{launches[k][1]} ({k_ms[k][1]:.2f})" for k in walls))
    turns = read_label_file(os.path.join(d, "convsp.turn.lbl"))
    segs = read_label_file(os.path.join(d, "convsp.seg.lbl"))
    rsegs = read_label_file(os.path.join(d, "convsp.reseg.lbl"))
    n_seg_spk = len({s.label for s in segs})
    n_rs_spk = len({s.label for s in rsegs})
    ders, found = {}, {}
    for label, sg in (("Segmentation", segs), ("ReSegmentation", rsegs)):
        hyp = np.full(n, -1, np.int64)
        hyp[sp_idx] = tdiar.segs_to_frames(sg, len(sp_idx))
        ders[label] = (der(ref, hyp), der(ref, hyp, DIAR_COLLAR))
        found[label] = tdiar.speakers_found(ref, hyp)
    print(f"  diar: {n} frames, {100 * ref_speech.mean():.1f} % speech; SAD "
          f"frame error {100 * sad_err:.3f} %; {len(turns) - 1} turns "
          f"detected; speakers found {found['Segmentation']} of 3 "
          f"({n_seg_spk} labels) by Segmentation, "
          f"{found['ReSegmentation']} of 3 ({n_rs_spk} labels) by "
          "ReSegmentation; DER " + ", ".join(
              f"{k} {100 * a:.2f} % (collar 25: {100 * b:.2f} %)"
              for k, (a, b) in ders.items()))
    check(sad_err <= DIAR_SAD_LIMIT, f"SAD frame error {sad_err} within "
          f"{DIAR_SAD_LIMIT}")
    # (the E-HMM may keep one or two small extra states)
    check(all(v == DIAR_SPK for v in found.values()),
          f"3 of 3 speakers found ({found})")
    for label, (a, _) in ders.items():
        check(a <= DIAR_DER_LIMIT, f"{label} DER {a:.4f} within "
              f"{DIAR_DER_LIMIT}")
    # launches the loops imply: TrainWorld nbTrainIt each; the E-HMM
    # 1 + (S-1)(1 + nbDecodeIt) adaptations x 3 MAP iterations (one grouped
    # K1 launch each, over all S rows) and 2 + (S-1)(nbDecodeIt + 1)
    # decodes; ReSegmentation 1 + nbTrainIt adaptations x 3 and nbTrainIt
    # + 1 decodes
    s_max = DIAR_MAX_SPEAKERS
    want = {f"TrainWorld[{ev}]": (4, 0)
            for ev in ("speech", "silence", "music", "world")}
    want.update({
        "AcousticSegmentation": (0, 1), "TurnDetection": (0, 0),
        "Segmentation": ((1 + (s_max - 1) * (1 + DIAR_DECODE_IT)) * 3,
                         2 + (s_max - 1) * (DIAR_DECODE_IT + 1)),
        "ReSegmentation": ((1 + DIAR_RESEG_IT) * 3, DIAR_RESEG_IT + 1)})
    for label, counts in want.items():
        check(launches[label] == counts, f"{label}: (K1, Viterbi) launches "
              f"{launches[label]}, expected {counts}")
    # a rerun of Segmentation reproduces every digit of the labels
    before = ({k: ck.launch_counts[k] for k in K1_KEYS},
              seg_hmm.launch_counts["viterbi"])
    run("Segmentation[rerun]", "Segmentation",
        seg_args + ["--saveLabelFileExtension", ".seg2.lbl"])
    with open(os.path.join(d, "convsp.seg.lbl")) as f1, \
            open(os.path.join(d, "convsp.seg2.lbl")) as f2:
        check(f1.read() == f2.read(), "Segmentation rerun writes the same "
              "label file")
    # an all-zero state row on the card comes back as the world
    world = GmmDiag.load(os.path.join(d, "wld.gmm"), device=dev)
    from lia_ral_tpu_torch.seg.diarization import (_batched_state_adapt,
                                                   _gather_rows)
    xs = torch.from_numpy(x[sp_idx]).to(dev)
    masks = torch.zeros((2, xs.shape[0]), device=dev)
    masks[0, :3000] = 1.0
    bank = _batched_state_adapt(torch.Generator(device=dev), xs, masks,
                                world, map_reg=3.0)
    check(all(bool(torch.isfinite(t).all())
              for t in (bank.weights, bank.means, bank.cov_inv))
          and torch.equal(bank.means[1], world.means),
          "an all-zero mask row comes back as the world, finite")
    # K1's grouped entry on the path's own frames: Segmentation's state
    # masks (rows past its speakers empty) and their adapted states, and
    # the two rows above; each row against the plain version of its own
    # frames, an empty row exact zeros
    lab = torch.from_numpy(tdiar.segs_to_frames(segs, len(sp_idx))).to(dev)
    seg_masks = (lab[None] == torch.arange(DIAR_MAX_SPEAKERS, device=dev)
                 [:, None]).float()
    seg_bank = _batched_state_adapt(torch.Generator(device=dev), xs,
                                    seg_masks, world, map_reg=3.0)
    grouped = {"name": "em_stats_fused_grouped", "route": "cuda",
               "source": SOURCE,
               "replaces": REPLACES["em_stats_fused"] + " (once a state)",
               "max_abs_err": 0.0}
    for label, mk, bk in (("Segmentation's states", seg_masks, seg_bank),
                          ("a 3000-frame and an empty state", masks, bank)):
        xc, wc, g = _gather_rows(xs, mk, DIAR_K_WORLD)
        got = ck.em_stats_fused(xc, wc, bk, groups=g)
        for r, (a, c) in enumerate(zip(g.starts, g.counts)):
            if c == 0:
                check(all(bool((getattr(got, f)[r] == 0).all())
                          for f in ("n", "sum_x", "sum_xx", "llk", "count")),
                      f"grouped K1, {label}: row {r} has no frame and "
                      "exact zeros")
                continue
            want = ck.em_stats_reference(
                xc[a:a + c], wc[a:a + c],
                GmmDiag(bk.weights[r], bk.means[r], bk.cov_inv[r]))
            err = check_stats(
                f"K1 em_stats_fused grouped, world K={DIAR_K_WORLD}, "
                f"{label}, row {r} of {len(g.counts)} ({c} frames)",
                [("n", got.n[r], want.n, n_rtol("")),
                 ("sum_x", got.sum_x[r], want.sum_x, sum_rtol("")),
                 ("sum_xx", got.sum_xx[r], want.sum_xx, sum_rtol(""))],
                (got.llk[r][None], want.llk[None]))
            check(float(got.count[r]) == float(want.count),
                  f"grouped K1, {label}: row {r} frame count")
            grouped["max_abs_err"] = max(grouped["max_abs_err"], err)
    entry_v = check_viterbi(dev)
    paths = ("cli-ivector", "gmm-ubm", "backend", "jfa")
    grouped["launches"] = 0
    grouped["launches_by_path"] = {p: 0 for p in paths}
    grouped["check_launches"] = 0
    grouped["library_ms"] = None
    kernels["em_stats_fused_grouped"] = grouped
    for kname, kv in kernels.items():
        got = main_k1.get(kname, 0)
        kv["launches_by_path"]["diarization"] = got
        kv["launches"] += got
    for kname in K1_KEYS:
        kernels[kname]["check_launches"] += (ck.launch_counts[kname]
                                             - before[0][kname])
    check_vit = seg_hmm.launch_counts["viterbi"] - before[1]
    entry_v.update(launches=main_vit, check_launches=check_vit,
                   launches_by_path={**{p: 0 for p in paths},
                                     "diarization": main_vit})
    kernels["viterbi"] = entry_v
    return d, len(sp_idx)


# -- phase 10: serving at full width -------------------------------------------

SERVE_TIMED_CALLS = 50
ADAPT_TARGETS = 10
AUDIO_RATE, AUDIO_SECONDS, AUDIO_K = 8000, 20, 128


def speech_frames(d, name):
    """The normalised speech frames of one phase-8 file (its label file's
    speech segments)."""
    cfg = Config({"featureFilesPath": d + "/", "labelFilesPath": d + "/",
                  "loadFeatureFileFormat": "SPRO4",
                  "loadFeatureFileExtension": ".norm.prm",
                  "labelSelectedFrames": "speech"})
    fs, m = load_features_and_mask([name], cfg)
    return np.ascontiguousarray(fs.data[m > 0], dtype=np.float32)


def synth_voice(rng, pitch, formants, seconds=AUDIO_SECONDS):
    """A voice-like waveform: harmonics of a wandering pitch shaped by
    three formant peaks, in bursts of 0.3-1.2 s separated by pauses of
    low noise."""
    n = int(seconds * AUDIO_RATE)
    t = np.arange(n) / AUDIO_RATE
    f0 = pitch * (1.0 + 0.05 * np.sin(2 * np.pi * 0.7 * t + rng.random()))
    phase = 2 * np.pi * np.cumsum(f0) / AUDIO_RATE
    sig = np.zeros(n)
    for h in range(1, int(3600 / pitch)):
        amp = sum(np.exp(-0.5 * ((h * pitch - f) / 180.0) ** 2)
                  for f in formants) + 0.02
        sig += amp * np.sin(h * phase + rng.random() * 6.28)
    gate = np.zeros(n)
    pos = 0
    while pos < n:
        on = int(rng.uniform(0.3, 1.2) * AUDIO_RATE)
        gate[pos:pos + on] = 1.0
        pos += on + int(rng.uniform(0.15, 0.5) * AUDIO_RATE)
    sig = sig / np.abs(sig).max() * 0.6 * gate
    return (sig + 0.003 * rng.standard_normal(n)).astype(np.float32)


def run_serving(gu_dir, gu_lists, kernels, dev) -> None:
    """Phase 10: the server and client on phase 6's world and features,
    the audio path, SpkAdapt."""
    half = UTT_PER_SPK // 2
    spk = [f"spk{s:02d}" for s in range(N_TGT)]
    world_path = os.path.join(gu_dir, "wld.gmm")
    world = GmmDiag.load(world_path, device=dev)
    work = temp_dir("lia_chip_smoke_srv_")
    # the decision threshold a deployment would set from its dev trials:
    # midway between phase 6's mean target and mean impostor LLR
    sc8, tgt8 = trial_scores(os.path.join(gu_dir, "main.nist"),
                             N_TGT * N_TGT * 5)
    threshold = 0.5 * float(sc8[tgt8].mean() + sc8[~tgt8].mean())
    # set-up, before the counts are zeroed: the audio path's world (8 kHz,
    # K = 128), trained through the library on two takes of four voices
    from lia_ral_tpu_torch.frontend.mfcc import MfccCfg, add_deltas, mfcc
    rng = np.random.default_rng(3)
    voices = [(110.0, (700, 1200, 2500)), (190.0, (400, 2000, 2800)),
              (140.0, (550, 1500, 2400)), (230.0, (650, 1700, 3100))]
    feats = [add_deltas(mfcc(torch.from_numpy(synth_voice(rng, p, f)
                                              ).to(dev), MfccCfg()))
             for p, f in voices for _ in range(2)]
    bg = torch.cat(feats)
    bg = (bg - bg.mean(0)) / bg.std(0)
    wbg = torch.ones(bg.shape[0], device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    aworld = train_model(gen, bg, wbg,
                         mixture_init(gen, bg, wbg, AUDIO_K,
                                      bagged_probability_init=1.0),
                         TrainCfg(nb_train_it=4))
    apath = os.path.join(work, "audio_wld.gmm")
    aworld.save(apath)
    ck.reset_launch_counts()
    srv = SpkDetServer(Config({"decisionThreshold": threshold}), port=0,
                       device=dev)
    port = srv.start()
    cli_ = RemoteSpkDetClient(port=port)
    try:
        cli_.load_world(world_path)
        t1 = time.perf_counter()
        train_ms = []
        for s in spk:
            x = np.concatenate([speech_frames(gu_dir, f"{s}_u{j}")
                                for j in range(half)])
            cli_.reset_features()
            cli_.send_features(x)
            before = ck.launch_counts["em_stats_fused"]
            t2 = time.perf_counter()
            cli_.train_speaker(s)
            train_ms.append(1e3 * (time.perf_counter() - t2))
            check(ck.launch_counts["em_stats_fused"] == before + 3,
                  f"train_speaker {s} launched K1 3 times")
        enrol_s = time.perf_counter() - t1
        check(f"speakers={','.join(spk)}" in cli_.status(),
              "40 speakers enrolled")
        # the server's models, for the reference LLRs
        models = []
        for s in spk:
            path = os.path.join(work, s + ".gmm")
            cli_.save_speaker(s, path)
            models.append(GmmDiag.load(path, device=dev))
            chain = GmmDiag.load(os.path.join(gu_dir, s + ".gmm"),
                                 device=dev)
            dm = float((models[-1].means - chain.means).abs().max())
            check(dm <= 1e-3 * float(chain.means.abs().max()),
                  f"server model {s} within 1e-3 of TrainTarget's ({dm:.2e})")
        clients = stack_gmms(models)
        tar, imp, worst = [], [], 0.0
        for i, s in enumerate(spk):
            x = speech_frames(gu_dir, f"{s}_u{half}")
            cli_.reset_features()
            cli_.send_features(x)
            xt = torch.from_numpy(x).to(dev)
            want = compute_test_llr(xt, torch.ones(x.shape[0], device=dev),
                                    world, clients, top_k=10).cpu().numpy()
            other = spk[(i + 7) % N_TGT]
            for uid, bucket in ((s, tar), (other, imp)):
                _, score = cli_.verify(uid)
                bucket.append(score)
                worst = max(worst, abs(score - want[spk.index(uid)]))
            if i % 8 == 0:
                _, best, uid = cli_.identify()
                j = int(np.argmax(want))
                check(uid == spk[j], f"identify on {s}'s segment: {uid}, "
                      f"reference {spk[j]}")
                worst = max(worst, abs(best - want[j]))
        check(worst <= 1e-3, f"served LLRs within 1e-3 of compute_test_llr "
              f"({worst:.3e})")
        thr = srv.worker.threshold
        print(f"  serving: {N_TGT} speakers enrolled in {enrol_s:.2f} s "
              f"(train_speaker median {statistics.median(train_ms):.1f} ms); "
              f"mean target LLR {np.mean(tar):.4f}, threshold {thr}, mean "
              f"impostor LLR {np.mean(imp):.4f}; max |LLR - reference| "
              f"{worst:.3e} over {2 * N_TGT + 5} requests")
        check(np.mean(tar) > thr > np.mean(imp),
              "mean target score above the threshold above the mean "
              "impostor score")
        # latency on the last segment in the buffer (2,000-frame bucket)
        lat = {}
        for name, call in (("verify", lambda: cli_.verify(spk[0])),
                           ("identify", cli_.identify)):
            call()
            ts = []
            for _ in range(SERVE_TIMED_CALLS):
                t2 = time.perf_counter()
                call()
                ts.append(1e3 * (time.perf_counter() - t2))
            ts.sort()
            lat[name] = (statistics.median(ts),
                         ts[int(0.95 * len(ts)) - 1])
        print(f"  serving: latency over {SERVE_TIMED_CALLS} calls "
              f"({srv.worker.feature_count()} frames in the buffer): "
              + ", ".join(f"{k} median {a:.2f} ms p95 {b:.2f} ms"
                          for k, (a, b) in lat.items()))
        # cumulative scores, then adapt_speaker
        cli_.reset_accumulated_scores()
        _, s1 = cli_.verify(spk[0], cumulative=True)
        _, s2 = cli_.verify(spk[0], cumulative=True)
        check(abs(s1 - s2) <= 1e-6, "cumulated score of one segment twice")
        cli_.identify(cumulative=True)
        cum = cli_.cumulated_results()
        check(len(cum) == N_TGT and all(np.isfinite(v) for _, v in cum),
              "cumulated results for 40 speakers")
        before = ck.launch_counts["em_stats_fused"]
        _, pre = cli_.verify(spk[-1])
        cli_.adapt_speaker(spk[-1])
        _, post = cli_.verify(spk[-1])
        check(ck.launch_counts["em_stats_fused"] == before + 2,
              "adapt_speaker launched K1 twice")
        check(post > pre, f"adapt_speaker on the buffer raised its score "
              f"({pre:.4f} -> {post:.4f})")

        # the audio path at 8 kHz, K = 128
        cli_.reset()                      # a new worker, on the same device
        check(srv.worker.device == dev, "G_RESET keeps the device")
        cli_.load_world(apath)

        def send(voice):
            cli_.reset_features()
            cli_.send_audio(synth_voice(rng, *voice))
            raw = srv.worker.feature_count()
            with srv._cmd_lock:           # no wire command normalises
                srv.worker.normalize_features(energy_column=19)
            return raw, srv.worker.feature_count()

        raw, kept = send(voices[0])
        check(raw == AUDIO_SECONDS * 100 - 1 and 0.3 * raw < kept < raw,
              f"audio: {raw} frames of 40 columns, {kept} kept by the VAD")
        cli_.train_speaker("voice0")
        send(voices[0])
        _, same = cli_.verify("voice0")
        send(voices[1])
        _, diff = cli_.verify("voice0")
        print(f"  serving [audio, 8 kHz, K={AUDIO_K}]: {raw} frames, {kept} "
              f"after VAD + CMVN; verify same voice {same:.4f}, another "
              f"voice {diff:.4f}")
        check(np.isfinite(same) and same > diff and same > 0,
              "audio path: the enrolled voice scores above another")
    finally:
        cli_.close()
        srv.stop()

    # SpkAdapt on 10 targets of phase 6: WMAP, without and with online ZNORM
    tgt = spk[:ADAPT_TARGETS]
    tests = [f"{s}_u{j}" for s in tgt for j in (half, half + 1)]
    lists = {k: os.path.join(work, k) for k in
             ("adapt_targets.ndx", "adapt_trials.ndx", "cohort.lst")}
    write_xlist(lists["adapt_targets.ndx"],
                [[s] + [f"{s}_u{j}" for j in range(half)] for s in tgt])
    write_xlist(lists["adapt_trials.ndx"], [[t] + tgt for t in tests])
    write_xlist(lists["cohort.lst"],
                [[f"spk{s:02d}_u{half}"] for s in range(N_TGT, N_SPK)])
    before = dict(ck.launch_counts)
    for label, extra in (("wmap", []),
                         ("wmap+znorm", ["--ZNORM", "true", "--impCohortFile",
                                         lists["cohort.lst"]])):
        out = os.path.join(work, label)
        os.makedirs(out)
        shutil.copy(world_path, os.path.join(out, "wld.gmm"))
        args = ["--torchDevice", dev.type, "--featureFilesPath", gu_dir + "/",
                "--labelFilesPath", gu_dir + "/", "--mixtureFilesPath",
                out + "/", "--loadFeatureFileFormat", "SPRO4",
                "--loadFeatureFileExtension", ".norm.prm",
                "--labelSelectedFrames", "speech",
                "--inputWorldFilename", "wld",
                "--targetIdList", lists["adapt_targets.ndx"],
                "--ndxFilename", lists["adapt_trials.ndx"],
                "--outputFilename", os.path.join(out, "adapt.nist")] + extra
        wall, _ = run_tool("SpkAdapt", args, {}, dev.type)
        sc, is_tgt = trial_scores(os.path.join(out, "adapt.nist"),
                                  len(tests) * ADAPT_TARGETS)
        for s in tgt:
            m = GmmDiag.load(os.path.join(out, s + ".gmm"))
            check(bool(torch.isfinite(m.means).all())
                  and not torch.equal(m.means, world.means.cpu()),
                  f"SpkAdapt [{label}] model {s} finite and adapted")
        print(f"  SpkAdapt [{label}]: {len(sc)} trials in {wall:.2f} s; mean "
              f"target score {sc[is_tgt].mean():.4f}, impostor "
              f"{sc[~is_tgt].mean():.4f}; EER "
              f"{100 * eer(sc[is_tgt], sc[~is_tgt]):.2f} %")
        check(sc[is_tgt].mean() > sc[~is_tgt].mean(),
              f"SpkAdapt [{label}]: targets score above impostors")
    check(ck.launch_counts == before, "SpkAdapt launches no kernel (its "
          "statistics are the f32 path by name)")
    launches = dict(ck.launch_counts)
    # 40 train_speaker x 3, adapt_speaker 2, the audio enrolment 3 and the
    # energy VAD of 3 normalize_features calls x 8 EM iterations
    check(launches["em_stats_fused"] == 3 * N_TGT + 2 + 3 + 3 * 8,
          f"K1 launches on the serving path "
          f"({launches['em_stats_fused']})")
    check(all(v == 0 for k, v in launches.items() if k != "em_stats_fused"),
          "only the default K1 launched on the serving path")
    print(f"  serving: launches {shown(launches)}")
    for kname, kv in kernels.items():
        got = launches.get(kname, 0)
        kv["launches_by_path"]["serving"] = got
        kv["launches"] += got


# -- phase 11: the GMM-supervector SVM system and the utility tools -----------

SVM_RANK = 40           # CovIntra's NAP rank
SVM_BG = 1000           # synthetic background of the N = 1,001 kernel check
SVM_TOL = 1e-3          # α (of max C), decisions and card-vs-CPU (of scale)
SVM_OBJ_RTOL = 1e-4     # dual objective, kernel against the plain loop
POLY_CPU_FILES = 10     # PolyExp's card-vs-CPU check reads the first 10
SVM_SOURCE = "lia_ral_tpu_torch/csrc/svm_dual.cu"
# the regimes' edges of the kernel's plan (one warp to 64 vectors, one
# block to 232, a cluster holding Q above, a cluster streaming it), and
# the timed N: the main path's, the background's and a large cohort's
SVM_REGIME_N = (64, 65, tsvm.RESIDENT_LIMIT, tsvm.RESIDENT_LIMIT + 1, 600,
                928, 929, 4096)
SVM_TIMED_N = (55, SVM_BG + 1, 4096)


def latent_svm_problem(n: int, dev, d: int = 512):
    """N // 10 targets against the rest, vectors with a 16-dimensional
    latent structure under 0.3 of noise (seed n)."""
    rng = np.random.default_rng(n)
    basis = rng.standard_normal((16, d)).astype(np.float32) / 4.0
    x = (rng.standard_normal((n, 16)).astype(np.float32) @ basis
         + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    x[:n // 10] += basis[0]
    y = np.r_[np.ones(n // 10), -np.ones(n - n // 10)].astype(np.float32)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))


# SM cycles of the solver's chain (csrc/svm_dual.cu), an estimate from
# its instructions and the latencies measured on the H100 (PERF.md
# section 6): a bisection round in one warp issues ~480
# instructions (31 mids; 31 x 2 candidate terms of 4 FP instructions in
# the FMA form of +-1 labels; the transpose-reduce's 31 shuffles, 62
# selects and 31 adds; the ballot and the walk) and waits on ~260 cycles
# of latency (five shuffle levels of 26, the ballot, the five-step walk,
# the mids' five levels); a combine of several warps adds a
# __syncthreads (20), of several blocks a cluster barrier (906 for 16);
# a matvec issues 11 instructions (three 16-byte shared loads, eight
# FMAs) for each 4 columns of a thread's two rows
SVM_ROUND_CYCLES, SVM_SYNC_CYCLES, SVM_CLUSTER_SYNC_CYCLES = 740, 20, 906


def svm_bound(n: int, n_iter: int = 500, hz: float = 1.98e9) -> dict:
    """``bound_ms`` and ``bound_by`` of one dual solve: the larger of the
    bytes (K once, y and C in, α out) over the memory rate and the f32
    operations (17 + n_iter matvecs of 2N², and n_iter + 1 projections of
    50 bisection steps of 5 operations an element) over the f32 rate,
    both microseconds; and ``chain_ms``, the estimate of the dependent
    chain that really limits it (``SVM_ROUND_CYCLES`` and the rest, for
    the regime of ``tsvm.solve_plan``, at the SM clock ``hz``; a streaming
    matvec at the cluster's share of 64 bytes a cycle an SM from L2).
    The estimate is printed, not put in the kernels line: its cycle
    counts are constants measured once (PERF.md section 6), not by this
    run."""
    t_bytes = 4 * (n * n + 3 * n) / HBM_BYTES_PER_S
    ops = ((tsvm.POWER_STEPS + 1 + n_iter) * 2 * n * n
           + (n_iter + 1) * tsvm.BISECTION_STEPS * 5 * n)
    t_ops = ops / F32_FLOPS_PER_S
    plan = tsvm.solve_plan(n)
    sync = (SVM_CLUSTER_SYNC_CYCLES if plan.cluster > 1 else
            SVM_SYNC_CYCLES if plan.threads > 32 else 0)
    rounds = tsvm.BISECTION_STEPS // tsvm.TREE_LEVELS
    projection = (rounds + 1) * (sync + 100) + rounds * SVM_ROUND_CYCLES
    if plan.resident:
        matvec = plan.vec_len // 4 * 11 + sync
    else:
        matvec = 4 * plan.rows * plan.vec_len / 64 + sync
    cycles = ((n_iter + 1) * projection
              + (tsvm.POWER_STEPS + 1 + n_iter) * matvec)
    out = {"bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "chain_ms": 1e3 * cycles / hz}
    return out


def dual_objective(k, y, alpha) -> float:
    """Σα − ½ αᵀ(K∘yyᵀ)α in float64 on the CPU."""
    k, y, a = (t.detach().cpu().double() for t in (k, y, alpha))
    q = k * (y[:, None] * y[None, :])
    return float(a.sum() - 0.5 * a @ q @ a)


def check_svm_dual(x55, y55, dev):
    """The SVM dual kernel against the plain loop on the main path's
    problem (target spk00's 5 napped supervectors against the 50 cohort
    vectors, N = 55, linear, default C; the plain loop on the card, timed
    once), the same problem with an rbf kernel and with targetPenalty 10,
    and a synthetic background of 1,000 vectors plus one target at d =
    79,872 (N = 1,001), linear and rbf (the plain loop on the CPU: on the
    card it is ~2·10⁵ launches, seconds a solve).  The background has a
    32-dimensional latent structure under 0.3 of noise: i.i.d. Gaussian
    vectors in 79,872 dimensions are all equidistant, and the rbf dual
    over them is degenerate (α differed by 1.2e-2·C between two correct
    solvers while the objective agreed to 2e-6).  rbf takes γ = 1/median
    squared distance (the default 1/d makes K nearly constant here).  α
    within SVM_TOL·max C and decisions K(α∘y) within SVM_TOL of their
    scale; where the f32 loop does not determine them that closely (at
    N = 1,001 rbf the plain loop moves α by ~1e-2·C when only its
    element order is reversed, and by as much against the same loop in
    float64: the default C puts α in the low bits of a ≈ lr), within
    twice the distance between the plain loop and itself run in reversed
    element order.  The dual objective within SVM_OBJ_RTOL, a rerun equal
    to the digit.  Then each regime of the kernel's plan at its edges
    (one warp at N = 64, one block at 65 and 232, a two-block cluster at
    233, seven blocks at 600, sixteen at 928, the streaming cluster at 929
    and 4,096) on latent-structure problems of
    512 dimensions, linear, against the plain loop on the CPU alike.  The
    kernel timed (median of 3, CUDA events) at N = 55, 1,001 and 4,096,
    with µs a FISTA step (one matvec and one projection: the time of 500
    steps less that of 0, over 500) and the chain estimate of
    ``svm_bound``.  Returns the kernels-line entry (without the launch
    counts)."""
    rng = np.random.default_rng(13)
    d = x55.shape[1]
    basis = rng.standard_normal((32, d), dtype=np.float32) / np.float32(
        np.sqrt(32))
    xb = (rng.standard_normal((SVM_BG + 1, 32), dtype=np.float32) @ basis
          + np.float32(0.3) * rng.standard_normal((SVM_BG + 1, d),
                                                  dtype=np.float32))
    xb[0] += np.float32(0.5) * basis[0]           # the target
    xb = torch.from_numpy(xb).to(dev)
    yb = torch.cat([torch.ones(1), -torch.ones(SVM_BG)]).to(dev)

    def problem(x, y, kind, penalty=None):
        c = tsvm.default_c(x.cpu().numpy())
        c_vec = torch.full_like(y, c)
        if penalty:
            c_vec[y > 0] *= penalty
        gamma = 0.0
        if kind == "rbf":
            sq = (x * x).sum(1)
            d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
            gamma = 1.0 / float(d2[d2 > 0].median())
        return tsvm.kernel_matrix(x, x, kind, gamma=gamma), c_vec

    cases = [("N=55 linear", x55, y55, "linear", None, True),
             ("N=55 rbf", x55, y55, "rbf", None, False),
             ("N=55 linear targetPenalty 10", x55, y55, "linear", 10.0, False),
             (f"N={SVM_BG + 1} linear", xb, yb, "linear", None, False),
             (f"N={SVM_BG + 1} rbf", xb, yb, "rbf", None, False)]
    for n in SVM_REGIME_N:
        xr, yr = latent_svm_problem(n, dev)
        cases.append((f"N={n} linear ({tsvm.solve_plan(n).regime})", xr, yr,
                      "linear", None, False))
    worst, times, plain_ms = 0.0, {}, None
    for label, x, y, kind, penalty, on_card in cases:
        k, c_vec = problem(x, y, kind, penalty)
        got = tsvm.dual_solve_cuda(k, y, c_vec)
        torch.cuda.synchronize()
        again = tsvm.dual_solve_cuda(k, y, c_vec)
        check(torch.equal(again, got), f"svm_dual {label}: a rerun "
              "reproduces every digit")
        if on_card:
            t1 = time.perf_counter()
            want = tsvm.dual_solve_reference(k, y, c_vec)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t1)
        else:
            want = tsvm.dual_solve_reference(k.cpu(), y.cpu(), c_vec.cpu())
        want = want.to(dev)
        c_max = float(c_vec.max())
        da = float((got - want).abs().max())
        dec_g, dec_w = k @ (got * y), k @ (want * y)
        ddec = float((dec_g - dec_w).abs().max())
        dscale = float(dec_w.abs().max())
        og, ow = dual_objective(k, y, got), dual_objective(k, y, want)
        tol_a, tol_dec = SVM_TOL * c_max, SVM_TOL * dscale
        note = ""
        if da > tol_a or ddec > tol_dec:
            # the plain loop against itself in reversed element order
            rev = tsvm.dual_solve_reference(
                k.cpu().flip(0).flip(1), y.cpu().flip(0),
                c_vec.cpu().flip(0)).flip(0).to(dev)
            sa = float((rev - want).abs().max())
            sdec = float((k @ (rev * y) - dec_w).abs().max())
            tol_a, tol_dec = max(tol_a, 2 * sa), max(tol_dec, 2 * sdec)
            note = (f"; the plain loop in reversed order moves α by "
                    f"{sa / c_max:.2e} of C and decisions by {sdec:.3e}")
        print(f"  svm_dual {label}: max|Δα| {da:.3e} ({da / c_max:.2e} of "
              f"C), max|Δdecision| {ddec:.3e} (scale {dscale:.3e}), dual "
              f"objective {og:.8e} vs plain {ow:.8e}; "
              f"{int((got > 1e-8).sum())} support vectors{note}")
        check(da <= tol_a and ddec <= tol_dec
              and abs(og - ow) <= SVM_OBJ_RTOL * abs(ow),
              f"svm_dual {label} agrees with the plain loop")
        worst = max(worst, da)
        n = x.shape[0]
        if kind == "linear" and penalty is None and n in SVM_TIMED_N \
                and n not in times:
            ms = statistics.median(
                cuda_ms(lambda: tsvm.dual_solve_cuda(k, y, c_vec))
                for _ in range(3))
            ms0 = statistics.median(
                cuda_ms(lambda: tsvm.dual_solve_cuda(k, y, c_vec, n_iter=0))
                for _ in range(3))
            hz = sm_clock_hz()
            bound = svm_bound(n, hz=hz)
            plan = tsvm.solve_plan(n)
            times[n] = {"ms": ms, "bound_ms": bound["bound_ms"],
                        "bound_by": bound["bound_by"],
                        "step_us": 1e3 * (ms - ms0) / 500}
            print(f"  svm_dual {label}: kernel {ms:.3f} ms (median of 3; "
                  f"{plan.regime}, {plan.cluster} block(s) of "
                  f"{plan.threads} threads), "
                  f"{times[n]['step_us']:.2f} us a FISTA step (matvec and "
                  f"projection), bound {bound['bound_ms']:.2e} ms by "
                  f"{bound['bound_by']}, chain estimate "
                  f"{bound['chain_ms']:.3f} ms at {hz / 1e6:.0f} MHz"
                  + (f", plain loop on the card {plain_ms:.1f} ms (once)"
                     if on_card else ""))
        del k, got, again, want, dec_g, dec_w
    return {"name": "svm_dual", "route": "cuda", "source": SVM_SOURCE,
            "replaces": "lia_ral_tpu/backend/svm.py:61 (jax.jit lax.scan; "
                        "no TPU kernel)",
            "max_abs_err": worst, **times[x55.shape[0]], "plain_ms": plain_ms,
            "library_ms": None,
            "shapes": {f"N={n}": times[n] for n in SVM_TIMED_N
                       if n != x55.shape[0]}}


def principal_sin(a, b) -> float:
    """‖P_a − P_b‖₂ of the row spaces of two orthonormal bases (the sin of
    their largest principal angle) as the largest singular value of a −
    (a·bᵀ)·b, linear in a perturbation (1 − σ_min(a·bᵀ)² would be
    quadratic, and f32 orthonormality would swamp it); float64 on the
    CPU, without the (d, d) projectors."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    return float(torch.linalg.matrix_norm(a - (a @ b.T) @ b, ord=2))


def run_gmm_svm(gu_dir, gu_lists, diar_dir, diar_frames, kernels, dev):
    """Phase 11: TrainTarget outputAdaptParam → CovIntra → NAPSV →
    SvmTrain → SvmPredict, ModelToSv, TrainTarget NAP, ComputeTest nap and
    dotProduct, NormFeat featNAP, then every other utility tool once, on
    phase 6's world, features, models and trials and phase 9's labels;
    launches and device ms per tool; card-vs-CPU checks of the numeric
    tools; the SVM dual kernel against its plain loop."""
    d = temp_dir("lia_chip_smoke_svm_")
    dt = dev.type
    half = UTT_PER_SPK // 2
    spk = [f"spk{s:02d}" for s in range(N_SPK)]
    tgt, coh = spk[:N_TGT], spk[N_TGT:]
    train = [f"{s}_u{j}" for s in spk for j in range(half)]
    tests = [f"{s}_u{j}" for s in tgt for j in range(half, UTT_PER_SPK)]
    poly = [n for (n,) in read_xlist(gu_lists["warp"])]      # 50 files

    def nap(n):
        return n + ".napped"

    lst = {}

    def write_list(name, rows):
        lst[name] = os.path.join(d, name)
        write_xlist(lst[name], rows)

    write_list("sessions.ndx", [[n, n] for n in train + tests])
    write_list("spk.ndx", [[f"{s}_u{j}" for j in range(half)] for s in spk])
    write_list("vectors.lst", [[n] for n in train + tests])
    write_list("cohort.lst", [[nap(f"{s}_u{j}")] for s in coh
                              for j in range(half)])
    write_list("svm_targets.ndx", [[s] + [nap(f"{s}_u{j}")
                                          for j in range(half)] for s in tgt])
    write_list("svm_trials.ndx", [[nap(t)] + tgt for t in tests])
    write_list("targets.ndx", [[s] + [f"{s}_u{j}" for j in range(half)]
                               for s in tgt])
    write_list("target_models.lst", [[s] for s in tgt])
    write_list("ten.lst", [[n] for n in poly[:10]])
    write_list("poly.lst", [[n] for n in poly])
    write_list("fuse.lst", [[os.path.join(gu_dir, "main.nist")],
                            [os.path.join(gu_dir, "ztnorm.nist")]])
    write_list("seq_train.ndx", [["A"] + [os.path.join(d, n + ".sym")
                                          for n in poly[:5]],
                                 ["B"] + [os.path.join(d, n + ".sym")
                                          for n in poly[5:10]]])
    write_list("seq_test.lst", [[os.path.join(d, n + ".sym")]
                                for n in poly[10:14]])
    write_list("labels.lst", [[os.path.join(diar_dir, f"convsp.{e}.lbl")]
                              for e in ("seg", "reseg")])
    with open(os.path.join(d, "weights.txt"), "w") as f:
        f.write("0.5 0.5\n")
    feat = gmm_ubm_args(gu_dir, dt)
    vec = ["--torchDevice", dt, "--vectorFilesPath", d + "/",
           "--vectorFilesExtension", ".vect"]
    mapk = ["--inputWorldFilename", "wld", "--MAPAlgo", "MAPOccDep",
            "--meanAdapt", "true", "--MAPRegFactorMean", "14",
            "--nbTrainIt", "3"]
    napm = os.path.join(d, "nap.mat")
    main_nist = os.path.join(gu_dir, "main.nist")
    first = poly[0]
    steps = [
        ("TrainTarget[outputAdaptParam]", "TrainTarget", feat + mapk + [
            "--targetIdList", lst["sessions.ndx"], "--outputAdaptParam",
            "true", "--superVector", "KL", "--saveVectorFilesPath", d + "/"]),
        ("CovIntra", "CovIntra", vec + [
            "--ndx", lst["spk.ndx"], "--nbEigenVectors", str(SVM_RANK),
            "--channelMatrix", napm]),
        ("NAPSV", "NAPSV", vec + ["--napMatrix", napm,
                                  "--inputVectorList", lst["vectors.lst"]]),
        ("SvmTrain", "SvmTrain", vec + [
            "--backgroundList", lst["cohort.lst"],
            "--targetIdList", lst["svm_targets.ndx"], "--kernelType", "0"]),
        ("SvmPredict", "SvmPredict", vec + [
            "--ndxFilename", lst["svm_trials.ndx"],
            "--outputFilename", os.path.join(d, "svm.nist")]),
        ("ModelToSv[meanSv]", "ModelToSv", [
            "--mixtureFilesPath", gu_dir + "/", "--vectorFilesPath", d + "/",
            "--inputModelList", lst["target_models.lst"],
            "--inputWorldFilename", "wld", "--meanSv", "true",
            "--normSv", "true", "--vectorFilesExtension", ".msv"]),
        ("ModelToSv[weightSv]", "ModelToSv", [
            "--mixtureFilesPath", gu_dir + "/", "--vectorFilesPath", d + "/",
            "--inputModelList", lst["target_models.lst"],
            "--inputWorldFilename", "wld", "--weightSv", "true",
            "--normSv", "true", "--vectorFilesExtension", ".wsv"]),
        ("TrainTarget[NAP]", "TrainTarget", feat + mapk + [
            "--targetIdList", lst["targets.ndx"], "--NAP", "true",
            "--NAPChannelMatrix", napm,
            "--saveMixtureFileExtension", ".nap.gmm"]),
        ("ComputeTest[nap]", "ComputeTest", feat + [
            "--computeTestMode", "nap", "--napMatrix", napm,
            "--ndxFilename", gu_lists["main"], "--inputWorldFilename", "wld",
            "--topDistribsCount", "10",
            "--outputFilename", os.path.join(d, "nap.nist")]),
        ("ComputeTest[dotProduct]", "ComputeTest", feat + [
            "--computeTestMode", "dotProduct", "--napMatrix", napm,
            "--ndxFilename", gu_lists["main"], "--inputWorldFilename", "wld",
            "--outputFilename", os.path.join(d, "dot.nist")]),
        ("NormFeat[featNAP]", "NormFeat", feat + [
            "--mode", "featNAP", "--inputFeatureFilename", lst["poly.lst"],
            "--inputWorldFilename", "wld", "--initChannelMatrix", napm,
            "--saveFeatureFileExtension", ".nap.prm"]),
        ("Scoring[NIST]", "Scoring", [
            "--inputFile", main_nist, "--mode", "NIST", "--threshold", "0",
            "--segTypeTest", "1side", "--trainTypeTest", "1side",
            "--adaptationMode", "n",
            "--outputFile", os.path.join(d, "scoring.nist04")]),
        ("Scoring[identification]", "Scoring", [
            "--inputFile", main_nist, "--scoringMode", "identification",
            "--outputFile", os.path.join(d, "ident.nist")]),
        ("FusionScore", "FusionScore", [
            "--inputFileList", lst["fuse.lst"],
            "--weights", os.path.join(d, "weights.txt"),
            "--outputFile", os.path.join(d, "fused.nist")]),
        ("ScoreWarp", "ScoreWarp", [
            "--inputFile", main_nist,
            "--outputFile", os.path.join(d, "warped.nist")]),
        ("Hist", "Hist", ["--inputFile", main_nist, "--nbBins", "50",
                          "--outputFile", os.path.join(d, "main.hist")]),
        ("ReadModel", "ReadModel", ["--mixtureFilesPath", gu_dir + "/",
                                    "--inputModelFilename", "wld"]),
        ("ReadFeatFile", "ReadFeatFile", [
            "--inputFeatureFilename",
            os.path.join(gu_dir, first + ".norm.prm")]),
        ("ExtractParams", "ExtractParams", feat + [
            "--inputFeatureFilename", lst["ten.lst"],
            "--featureServerMask", "0-12",
            "--saveFeatureFileExtension", ".ext.prm"]),
        ("PolyExp[computeR]", "PolyExp", feat + [
            "--inputFeatureFilename", lst["poly.lst"],
            "--computeR", os.path.join(d, "poly.R")]),
        ("PolyExp[normalize]", "PolyExp", feat + [
            "--inputFeatureFilename", lst["poly.lst"],
            "--normalize", os.path.join(d, "poly.R"),
            "--vectorFilesPath", d + "/",
            "--vectorFilesExtension", ".nexp.vect"]),
        ("PolyExp", "PolyExp", feat + [
            "--inputFeatureFilename", lst["poly.lst"],
            "--vectorFilesPath", d + "/"]),
        ("GmmTokenizer", "GmmTokenizer", feat + [
            "--inputFeatureFilename", lst["poly.lst"],
            "--inputWorldFilename", "wld", "--symbolsFilesPath", d + "/"]),
        ("GmmTokenizer[confusion]", "GmmTokenizer", feat + [
            "--inputFeatureFilename", lst["poly.lst"],
            "--inputWorldFilename", "wld", "--confusionMatrix", "true",
            "--topDistribsCount", "10",
            "--matrixOutputName", os.path.join(d, "mce.mat")]),
    ] + [(f"BNGram[{o}]", "BNGram", [
        "--inputSymFile", os.path.join(d, first + ".sym"),
        "--ngramOrder", str(o),
        "--outputFile", os.path.join(d, f"ngram{o}.dta")]) for o in (1, 2, 3)
    ] + [
        ("LabelNGram", "LabelNGram", [
            "--inputFilename", first,
            "--NGramFilename", os.path.join(d, "ngram3.dta"),
            "--NGramOrder", "3", "--NGramSelected", "16",
            "--symbolPath", d + "/", "--labelOutputPath", d + "/"]),
        ("SequenceExtractor", "SequenceExtractor", [
            "--ngramFilename", os.path.join(d, "ngram"), "--ngramExt", ".dta",
            "--maxOrder", "3", "--nbInputSymb", str(K), "--nbOutputSymb",
            "64", "--outputFilename", os.path.join(d, "seq.dec"),
            "--outputInfoFilename", os.path.join(d, "seq.info")]),
        ("SequenceDecode", "SequenceDecode", [
            "--trainList", lst["seq_train.ndx"],
            "--testList", lst["seq_test.lst"], "--ngramOrder", "2"]),
        ("LabelFusion", "LabelFusion", [
            "--labelFileList", lst["labels.lst"],
            "--nbFrames", str(diar_frames), "--closeGap", "50",
            "--dropShort", "30",
            "--outputFile", os.path.join(d, "fused.lbl")]),
        ("TimeCluster", "TimeCluster", [
            "--inputFile", os.path.join(diar_dir, "convsp.seg.lbl"),
            "--minDuration", "1.0",
            "--outputFile", os.path.join(d, "timecluster.lbl")]),
    ]
    walls, k_ms, launches, stdout = {}, {}, {}, {}
    ck.reset_launch_counts()
    tsvm.reset_launch_counts()
    seg_hmm.reset_launch_counts()
    for label, tool, args in steps:
        k1, sv = ck.launch_counts["em_stats_fused"], \
            tsvm.launch_counts["svm_dual"]
        kms = {}
        walls[label], stdout[label] = run_tool(tool, args, kms, dt)
        k_ms[label] = (kms.get("em_stats_fused", 0.0),
                       kms.get("dual_solve_cuda", 0.0))
        launches[label] = (ck.launch_counts["em_stats_fused"] - k1,
                           tsvm.launch_counts["svm_dual"] - sv)
    main = {**ck.launch_counts, **seg_hmm.launch_counts,
            **tsvm.launch_counts}
    print("  gmm-svm: tool wall s " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()))
    print("  gmm-svm: K1 launches (device ms) / svm_dual launches (device "
          "ms) " + ", ".join(
              f"{k} {launches[k][0]} ({k_ms[k][0]:.2f}) / {launches[k][1]} "
              f"({k_ms[k][1]:.2f})" for k in walls if any(launches[k])))
    print(f"  gmm-svm: launches {shown(main)}")
    want = {label: (0, 0) for label in walls}
    want.update({"TrainTarget[outputAdaptParam]": (3 * (len(train)
                                                        + len(tests)), 0),
                 "TrainTarget[NAP]": (3 * N_TGT, 0),
                 "SvmTrain": (0, N_TGT)})
    for label, counts in want.items():
        check(launches[label] == counts, f"{label}: (K1, svm_dual) launches "
              f"{launches[label]}, expected {counts}")
    check(all(v == 0 for k, v in main.items()
              if k not in ("em_stats_fused", "svm_dual")),
          "only the default K1 and svm_dual on the gmm-svm path")

    # the outputs of the chain
    n_dim = K * D
    nap_u = read_matrix_file(napm)
    check(nap_u.shape == (SVM_RANK, n_dim) and np.allclose(
        nap_u @ nap_u.T, np.eye(SVM_RANK), atol=1e-4),
        f"CovIntra: {SVM_RANK} orthonormal rows of {n_dim}")
    for n in train + tests:
        v = read_matrix_file(os.path.join(d, nap(n) + ".vect"))
        check(v.shape == (1, n_dim) and bool(np.isfinite(v).all()),
              f"NAPSV output {n}")
    check(float(np.abs(nap_u @ v.ravel()).max())
          <= 1e-4 * float(np.abs(v).max()) * np.sqrt(n_dim),
          "NAPSV leaves nothing along the NAP subspace")
    for s in tgt:
        for ext, size in ((".msv", n_dim), (".wsv", K)):
            v = read_matrix_file(os.path.join(d, s + ext))
            check(v.shape == (1, size) and bool(np.isfinite(v).all()),
                  f"ModelToSv {s}{ext}")
        m = GmmDiag.load(os.path.join(gu_dir, s + ".nap.gmm"))
        sv = m.means.reshape(-1).double().numpy()
        check(bool(np.isfinite(sv).all())
              and float(np.abs(nap_u @ sv).max()) <= 1e-3 * np.abs(sv).max()
              * np.sqrt(n_dim), f"TrainTarget NAP model {s}")
    for n in poly:
        y = read_feature_file(os.path.join(gu_dir, n + ".nap.prm")).data
        check(y.shape == (T_UTT, D) and bool(np.isfinite(y).all()),
              f"featNAP output {n}")
    eers = {}
    for name in ("svm", "nap", "dot"):
        sc, is_tgt = trial_scores(os.path.join(d, name + ".nist"),
                                  N_TGT * N_TGT * 5)
        check(int(is_tgt.sum()) == N_TGT * 5, f"{name}: 200 target trials")
        eers[name] = 100 * eer(sc[is_tgt], sc[~is_tgt])
        print(f"  gmm-svm [{name}]: mean target score "
              f"{sc[is_tgt].mean():.6g}, impostor {sc[~is_tgt].mean():.6g}; "
              f"EER {eers[name]:.2f} % over {is_tgt.sum()} target / "
              f"{(~is_tgt).sum()} impostor trials")
        check(sc[is_tgt].mean() > sc[~is_tgt].mean(),
              f"{name}: mean target score above mean impostor score")
    # the other tools' outputs
    for name, n in (("ident.nist", 200), ("fused.nist", 8000),
                    ("warped.nist", 8000)):
        lines = read_nist_scores(os.path.join(d, name))
        check(len(lines) == n and all(np.isfinite(r.score) for r in lines),
              f"{name}: {n} finite scores")
    with open(os.path.join(d, "scoring.nist04")) as f:
        check(len(f.read().splitlines()) == 8000, "Scoring NIST: 8000 lines")
    with open(os.path.join(d, "main.hist")) as f:
        check(len(f.read().splitlines()) == 50, "Hist: 50 bins")
    check(len(stdout["ReadModel"].splitlines()) == 1 + 3 * K,
          "ReadModel prints every component")
    check(len(stdout["ReadFeatFile"].splitlines()) == T_UTT,
          "ReadFeatFile prints every frame")
    for n in poly[:10]:
        check(read_feature_file(os.path.join(gu_dir, n + ".ext.prm")).data
              .shape == (T_UTT, 13), f"ExtractParams output {n}")
    r_rows = np.loadtxt(os.path.join(d, "poly.R"))
    n_poly = (D + 3) * (D + 2) * (D + 1) // 6
    check(r_rows.shape == (n_poly, 2) and bool(np.isfinite(r_rows).all()),
          f"PolyExp computeR: {n_poly} rows")
    for ext in (".exp.vect", ".nexp.vect"):
        v = read_matrix_file(os.path.join(d, first + ext))
        check(v.shape == (1, n_poly) and bool(np.isfinite(v).all()),
              f"PolyExp output {first}{ext}")
    mce = np.loadtxt(os.path.join(d, "mce.mat"), skiprows=1)
    check(mce.shape == (K, K) and mce.sum() > 0, "GmmTokenizer confusion "
          "matrix")
    for name in ("seq.dec", "seq.info", "ngram3.dta", first + ".sym.lbl",
                 "fused.lbl", "timecluster.lbl"):
        check(os.path.getsize(os.path.join(d, name)) > 0, f"{name} written")
    check(len(stdout["SequenceDecode"].splitlines()) == 4,
          "SequenceDecode decodes 4 streams")

    # card against the CPU on the same files: CovIntra, PolyExp,
    # SvmPredict, GmmTokenizer (per-frame symbols)
    cpu = ["--torchDevice", "cpu"]
    run_tool("CovIntra", vec + cpu + [
        "--ndx", lst["spk.ndx"], "--nbEigenVectors", str(SVM_RANK),
        "--channelMatrix", os.path.join(d, "nap_cpu.mat")], {}, "cpu")
    sin_max = principal_sin(nap_u, read_matrix_file(
        os.path.join(d, "nap_cpu.mat")))
    print(f"  gmm-svm: CovIntra card vs CPU: ‖P_card − P_cpu‖₂ {sin_max:.3e}")
    check(sin_max <= SVM_TOL, "CovIntra's subspace on the card and the CPU")
    run_tool("PolyExp", feat + cpu + [
        "--inputFeatureFilename", lst["ten.lst"], "--vectorFilesPath",
        d + "/", "--vectorFilesExtension", ".exp.cpu.vect"], {}, "cpu")
    worst = 0.0
    for n in poly[:POLY_CPU_FILES]:
        a = read_matrix_file(os.path.join(d, n + ".exp.vect"))
        b = read_matrix_file(os.path.join(d, n + ".exp.cpu.vect"))
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    print(f"  gmm-svm: PolyExp card vs CPU ({POLY_CPU_FILES} files): max "
          f"|Δ| {worst:.3e} of scale")
    check(worst <= SVM_TOL, "PolyExp on the card and the CPU")
    run_tool("SvmPredict", vec + cpu + [
        "--ndxFilename", lst["svm_trials.ndx"],
        "--outputFilename", os.path.join(d, "svm_cpu.nist")], {}, "cpu")
    a = np.array([r.score for r in read_nist_scores(os.path.join(
        d, "svm.nist"))])
    b = np.array([r.score for r in read_nist_scores(os.path.join(
        d, "svm_cpu.nist"))])
    err = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"  gmm-svm: SvmPredict card vs CPU: max |Δ| {err:.3e} of scale")
    check(err <= SVM_TOL, "SvmPredict on the card and the CPU")
    frames = {}
    for label, dev_args in (("card", ["--torchDevice", dt]), ("cpu", cpu)):
        out = os.path.join(d, "tok_" + label)
        os.makedirs(out)
        run_tool("GmmTokenizer", feat + dev_args + [
            "--inputFeatureFilename", lst["poly.lst"],
            "--inputWorldFilename", "wld", "--duration", "true",
            "--symbolsFilesPath", out + "/"], {}, dev_args[1])
        frames[label] = np.concatenate([
            np.loadtxt(os.path.join(out, n + ".sym"), dtype=np.int64)
            for n in poly])
    flips = int((frames["card"] != frames["cpu"]).sum())
    print(f"  gmm-svm: GmmTokenizer card vs CPU: {flips} of "
          f"{frames['cpu'].size} frames' symbols differ")
    check(flips <= SVM_TOL * frames["cpu"].size,
          "GmmTokenizer's symbols on the card and the CPU")

    # the kernel against its plain loop, on the main path's problem of
    # target spk00 and at N = 1,001
    vecs = [read_matrix_file(os.path.join(d, nap(f"{s}_u{j}") + ".vect"))
            .ravel() for s in [tgt[0]] + coh for j in range(half)]
    x55 = torch.as_tensor(np.stack(vecs), dtype=torch.float32, device=dev)
    y55 = torch.cat([torch.ones(half), -torch.ones(len(coh) * half)]).to(dev)
    before = tsvm.launch_counts["svm_dual"]
    entry_s = check_svm_dual(x55, y55, dev)
    paths = ("cli-ivector", "gmm-ubm", "backend", "jfa", "diarization",
             "serving")
    entry_s.update(launches=main["svm_dual"],
                   check_launches=tsvm.launch_counts["svm_dual"] - before,
                   launches_by_path={**{p: 0 for p in paths},
                                     "gmm-svm": main["svm_dual"]})
    for kname, kv in kernels.items():
        got = main.get(kname, 0)
        kv["launches_by_path"]["gmm-svm"] = got
        kv["launches"] += got
    kernels["svm_dual"] = entry_s
    print(f"  gmm-svm: EER SVM {eers['svm']:.2f} %, NAP {eers['nap']:.2f} %, "
          f"dotProduct {eers['dot']:.2f} %")


# -- phase 12: numThread sharding and the multi-process runtime --------------

PAR_SHARDS = 4          # shards of the one card (numThread 4)
PAR_TOL = 1e-3          # a sharded result against the serial one, of scale
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "_torch_multihost_worker.py")


def par_mesh(dev, n_data=PAR_SHARDS, n_model=1):
    """A mesh of n_data × n_model shards of the one device."""
    return pmesh.make_mesh(n_data, n_model, [dev] * (n_data * n_model))


def leaves(obj) -> list:
    """The tensors of a result: a tensor, a tuple of results, a state
    dataclass."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in leaves(o)]
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def check_scaled(label, got, want, tol=PAR_TOL) -> float:
    """max|got − want| within tol·max|want|, printed; returns the error
    relative to the scale."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    print(f"  parallel {label}: max|sharded - serial| {err:.3e} (scale "
          f"{scale:.3e})")
    check(err <= tol * scale, f"{label} within {tol} of scale")
    return err / max(scale, 1e-30)


def multihost_problems(outdir, x, w, ubm) -> None:
    """tests/_torch_multihost_worker.py's inputs: phase 3's 1M frames and
    phase 5's UBM for the EM stats, then the PLDA, TV, JFA and extraction
    problems of tests/_multihost_worker.py at its shapes and seeds, their
    random inits drawn here (numpy and torch's CPU generator)."""
    gen = torch.Generator().manual_seed(3)
    rngp = np.random.default_rng(7)
    vecs = rngp.standard_normal((16, 10)).astype(np.float32)
    cov = np.cov(vecs.T).astype(np.float32)
    plda = PldaModel.init(gen, 10, 4, 2, data_mean=torch.from_numpy(
        vecs.mean(0)), data_cov=torch.from_numpy(cov))
    rngt = np.random.default_rng(9)

    def gmm_np(rng_, k, d):
        gw = rng_.random(k) + 0.5
        return gmm_from_numpy(gw / gw.sum(),
                              rng_.standard_normal((k, d)).astype(np.float32),
                              (rng_.random((k, d)) + 0.5).astype(np.float32))

    tv_model = init_t(gen, 3, gmm_np(rngt, 6, 4))
    tv_n = (rngt.random((8, 6)) * 20 + 1).astype(np.float32)
    tv_f = (rngt.standard_normal((8, 6, 4)) * 3).astype(np.float32)
    rngj = np.random.default_rng(11)
    gmm_j = gmm_np(rngj, 6, 4)
    jfa_n = (rngj.random((12, 6)) * 20 + 1).astype(np.float32)
    jfa_f = (rngj.standard_normal((12, 6, 4)) * 3).astype(np.float32)
    jmodel = JfaModel.init(gen, 2, 2, gmm_j, scale=0.1)
    arr = {k: v.numpy() for k, v in (
        ("plda_mean", plda.mean), ("plda_f", plda.f), ("plda_g", plda.g),
        ("plda_sigma", plda.sigma), ("tv_t", tv_model.t),
        ("tv_means", tv_model.ubm_means), ("tv_iv", tv_model.ubm_inv_var),
        ("jfa_v", jmodel.v), ("jfa_u", jmodel.u), ("jfa_d", jmodel.d),
        ("jfa_means", jmodel.ubm_means), ("jfa_iv", jmodel.ubm_inv_var))}
    np.savez(os.path.join(outdir, "problems.npz"),
             x=x.cpu().numpy(), w=w.cpu().numpy(),
             gmm_w=ubm.weights.cpu().numpy(), gmm_m=ubm.means.cpu().numpy(),
             gmm_ci=ubm.cov_inv.cpu().numpy(), plda_x=vecs,
             plda_ids=np.arange(16) % 4, plda_n_spk=4, tv_n=tv_n, tv_f=tv_f,
             jfa_n=jfa_n, jfa_f=jfa_f, jfa_spk=np.arange(12) % 4,
             jfa_n_spk=4,
             jfa_x=(rngj.standard_normal((12, 2)) * 0.1).astype(np.float32),
             jfa_z=np.zeros((4, 6, 4), np.float32), pcg_tol=1e-7, **arr)


def start_workers(outdir, kind, n=2):
    """The worker processes of the two-rank run on ``kind`` (cuda: both
    on cuda:0; gloo over a free localhost port); returns them, started."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, WORKER, f"127.0.0.1:{port}", str(n), str(pid),
         outdir, kind], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(n)]


def check_workers(procs, outdir, serial_k1, dev) -> dict:
    """The two ranks' results: equal to each other to the digit, K1
    launched once a rank, the EM stats within the K1 budgets of the
    single-process K1 at 1M frames, the other problems within
    tests/test_torch_multihost.py's tolerances of the serial functions on
    the card.  Returns each rank's launch counts."""
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        finally:
            p.kill()
        check(p.returncode == 0, f"multi-process worker failed:\n{out}")
    info = [json.load(open(os.path.join(outdir, f"names_{pid}.json")))
            for pid in range(len(procs))]
    shards = [i["names"] for i in info]
    check(not set(shards[0]) & set(shards[1])
          and sorted(shards[0] + shards[1]) == sorted(f"f{i}"
                                                      for i in range(10)),
          "shard_file_list gives disjoint shards covering the list")
    for pid, i in enumerate(info):
        print(f"  parallel 2 processes: rank {pid} mesh {i['mesh']}, "
              f"{i['local']} local shard, launches "
              f"{ {k: v for k, v in i['launches'].items() if v} }")
        check(i["launches"]["em_stats_fused"] == 1
              and sum(i["launches"].values()) == 1,
              f"rank {pid} launched K1 once for global_stats")

    def load(name):
        got = [dict(np.load(os.path.join(outdir, f"{name}_{pid}.npz")))
               for pid in range(len(procs))]
        for key in got[0]:
            check(np.array_equal(got[0][key], got[1][key]),
                  f"both ranks hold the same {name} {key}")
        return {k: torch.from_numpy(v).to(dev) for k, v in got[0].items()}

    got = load("stats")
    check_stats("global_stats 2 ranks vs K1 1M frames",
                [("n", got["n"], serial_k1.n, n_rtol("")),
                 ("sum_x", got["sum_x"], serial_k1.sum_x, sum_rtol("")),
                 ("sum_xx", got["sum_xx"], serial_k1.sum_xx, sum_rtol(""))],
                (got["llk"][None], serial_k1.llk[None]))
    check(float(got["count"]) == float(serial_k1.count),
          "global_stats count exact")
    p = np.load(os.path.join(outdir, "problems.npz"))
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in p.items()
         if k not in ("x", "w")}
    plda = PldaModel(mean=t["plda_mean"], f=t["plda_f"], g=t["plda_g"],
                     sigma=t["plda_sigma"])
    ref = plda_em_iteration(plda, DevSet(t["plda_x"], t["plda_ids"], 4))
    got = load("plda")
    for key in ("f", "sigma"):
        check(torch.allclose(got[key], getattr(ref, key), rtol=1e-4,
                             atol=1e-4), f"2-rank PLDA {key}")
    tv_model = TvModel(t=t["tv_t"], ubm_means=t["tv_means"],
                       ubm_inv_var=t["tv_iv"])
    tv_stats = BwStats(n=t["tv_n"], f=t["tv_f"])
    _, ref_tv = tv_e_step(tv_stats, tv_model, chunk=4)
    got = load("tv")
    for key in ("a", "c", "r_mat", "r_vec"):
        check(torch.allclose(got[key], getattr(ref_tv, key), rtol=2e-3,
                             atol=2e-3), f"2-rank TV E-step {key}")
    jstats = JfaStats.from_sessions(BwStats(n=t["jfa_n"], f=t["jfa_f"]),
                                    p["jfa_spk"], 4)
    jmodel = JfaModel(v=t["jfa_v"], u=t["jfa_u"], d=t["jfa_d"],
                      ubm_means=t["jfa_means"], ubm_inv_var=t["jfa_iv"])
    ref_m, ref_y = jfa_v_iteration(jstats, jmodel, t["jfa_x"], t["jfa_z"])
    got = load("jfa")
    check(torch.allclose(got["v"], ref_m.v, rtol=2e-4, atol=2e-5)
          and torch.allclose(got["y"], ref_y, rtol=2e-4, atol=2e-5),
          "2-rank JFA V iteration")
    ref_w = estimate_w(tv_stats, tv_model, chunk=2, pcg_iters=12)
    check(torch.allclose(load("w_iv")["w"], ref_w, rtol=2e-3, atol=2e-3),
          "2-rank i-vector extraction")
    print("  parallel 2 processes: PLDA EM, TV E-step, JFA V iteration and "
          "extraction equal the serial functions within "
          "tests/test_torch_multihost.py's tolerances; ranks equal to the "
          "digit")
    return {f"rank{pid}": i["launches"] for pid, i in enumerate(info)}


def run_parallel(xu, mask, workdir, gu_dir, gu_lists, kernels, dev):
    """Phase 12: the sharded functions on meshes of shards of the one card
    against their serial versions, TrainWorld and TotalVariability with
    numThread 4, and two processes on the card under gloo."""
    xf, wf = xu.reshape(-1, D), mask.reshape(-1)
    out = os.path.join(workdir, "default")
    ubm = GmmDiag.load(os.path.join(out, "wld.gmm"), device=dev)
    mh_dir = temp_dir("lia_chip_smoke_mh_")
    t1 = time.perf_counter()
    multihost_problems(mh_dir, xf, wf, ubm)
    procs = start_workers(mh_dir, dev.type)
    print(f"  parallel: 2 worker processes started "
          f"({time.perf_counter() - t1:.1f} s to write their inputs)")
    path, compare = collections.Counter(), collections.Counter()

    def counted(into, fn):
        """fn() with the launch counts from 0; adds them to ``into``."""
        ck.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        into.update(ck.launch_counts)
        return res, dict(ck.launch_counts)

    def twice(label, fn):
        """The main-path call and its rerun, equal to the digit."""
        res, c = counted(path, fn)
        again, _ = counted(path, fn)
        check(all(torch.equal(a, b) for a, b in zip(leaves(res),
                                                    leaves(again))),
              f"{label}: a rerun is equal to the digit")
        return res, c

    mesh = par_mesh(dev)
    serial = {}
    for tier in ("", "fastStats"):
        cdt, sp = TIERS[tier]
        key = entry("em_stats_fused", tier)
        fn = sharded_stats_fn(mesh, fast_stats=tier == "fastStats")
        got, c = twice(f"sharded K1 {key}", lambda: fn(xf, wf, ubm))
        check(c[key] == PAR_SHARDS and sum(c.values()) == PAR_SHARDS,
              f"sharded_stats_fn launched {key} once a shard ({c})")
        want, _ = counted(compare, lambda: ck.em_stats_fused(
            xf, wf, ubm, compute_dtype=cdt, stats_pass=sp))
        serial[tier] = want
        check_stats(f"sharded {key} {PAR_SHARDS} x 1 vs K1 1M frames",
                    [("n", got.n, want.n, n_rtol(tier)),
                     ("sum_x", got.sum_x, want.sum_x, sum_rtol(tier)),
                     ("sum_xx", got.sum_xx, want.sum_xx, sum_rtol(tier))],
                    (got.llk[None], want.llk[None]))
        check(float(got.count) == float(want.count), f"{key} count exact")
    mesh22 = par_mesh(dev, 2, 2)
    got, _ = twice("sharded_em_stats_2d", lambda: sharded_em_stats_2d(
        mesh22, xf, wf, ubm))
    want = em_stats_chunked(xf, wf, ubm)
    check_stats("sharded_em_stats_2d 2 x 2 vs em_stats_chunked",
                [("n", got.n, want.n, 1e-4),
                 ("sum_x", got.sum_x, want.sum_x, 1e-3),
                 ("sum_xx", got.sum_xx, want.sum_xx, 1e-3)],
                (got.llk[None], want.llk[None]))
    del got, want

    # the TV E-step and extraction on phase 5's stats and T
    tv = TvModel.load(os.path.join(out, "TV.matx"), ubm)
    tv = tv.replace(ubm_means=torch.as_tensor(
        read_matrix_file(os.path.join(out, "TVmean.matx")).reshape(K, D),
        dtype=torch.float32, device=dev))
    stats, _ = load_stats(os.path.join(out, "tv_accs.npz"), device=dev)
    w_ser, acc_ser = tv_e_step(stats, tv)
    for label, fn in (
            (f"sharded_tv_e_step {PAR_SHARDS} x 1",
             lambda: sharded_tv_e_step(mesh, stats, tv)),
            ("sharded_tv_e_step_2d 2 x 2",
             lambda: sharded_tv_e_step_2d(mesh22, stats, tv))):
        torch.cuda.reset_peak_memory_stats()
        (w_shd, acc_shd), _ = twice(label, fn)
        print(f"  parallel {label}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"(each shard's a: {4 * K * R * R / 2**30:.2f} GiB at full "
              "K, half that at K/2)")
        check_scaled(f"{label} w", w_shd, w_ser)
        for f in ("a", "c", "r_mat", "r_vec", "n_utts"):
            check_scaled(f"{label} {f}", getattr(acc_shd, f),
                         getattr(acc_ser, f))
        del w_shd, acc_shd
    del acc_ser
    w_ser = estimate_w(stats, tv, pcg_tol=0.0)
    w_shd, _ = twice("sharded_estimate_w", lambda: sharded_estimate_w(
        mesh, stats, tv, pcg_tol=0.0))
    check_scaled(f"sharded_estimate_w {PAR_SHARDS} x 1 (pcg_tol 0)", w_shd,
                 w_ser)

    # JFA V and U iterations on phase 8's stats and subspaces
    world = GmmDiag.load(os.path.join(gu_dir, "wld.gmm"), device=dev)
    accs = os.path.join(gu_dir, "jfa_accs.npz")
    sess, _ = load_stats(accs, device=dev)
    jstats = JfaStats.from_sessions(sess, np.load(accs + ".spk.npy"), N_SPK)

    def subspace(name, rank):
        return torch.as_tensor(read_matrix_file(os.path.join(
            gu_dir, name + ".matx")).reshape(rank, K, D),
            dtype=torch.float32, device=dev)

    jmodel = JfaModel(v=subspace("EV", JFA_RV), u=subspace("EC", JFA_RU),
                      d=torch.zeros_like(world.means), ubm_means=world.means,
                      ubm_inv_var=world.cov_inv)
    x0 = torch.zeros((jstats.sess.n.shape[0], JFA_RU), device=dev)
    z0 = torch.zeros((N_SPK, K, D), device=dev)
    m_ser, y_ser = jfa_v_iteration(jstats, jmodel, x0, z0)
    (m_shd, y_shd), _ = twice("sharded_jfa_v_iteration",
                              lambda: sharded_jfa_v_iteration(
                                  mesh, jstats, jmodel, x0, z0))
    check_scaled("sharded_jfa_v_iteration V", m_shd.v, m_ser.v)
    check_scaled("sharded_jfa_v_iteration y", y_shd, y_ser)
    m_ser, x_ser = jfa_u_iteration(jstats, jmodel, y_ser, z0)
    (m_shd, x_shd), _ = twice("sharded_jfa_u_iteration",
                              lambda: sharded_jfa_u_iteration(
                                  mesh, jstats, jmodel, y_ser, z0))
    check_scaled("sharded_jfa_u_iteration U", m_shd.u, m_ser.u)
    check_scaled("sharded_jfa_u_iteration x", x_shd, x_ser)
    del m_ser, m_shd, jmodel, jstats, sess

    # PLDA EM and scoring on phase 7's normalised dev set and trials
    norm = os.path.join(out, "norm")
    names = [f"spk{i // UTT_PER_SPK:02d}_u{i % UTT_PER_SPK}"
             for i in range(N_SPK * UTT_PER_SPK)]
    vecs = torch.as_tensor(load_vectors(names, Config(
        {"loadVectorFilesPath": norm + "/"})), device=dev)
    spk_ids = torch.arange(N_SPK, device=dev).repeat_interleave(UTT_PER_SPK)
    dev_set = DevSet(vecs, spk_ids, N_SPK)
    plda = PldaModel.load(os.path.join(norm, "plda.npz"), device=dev)
    ser = plda_em_iteration(plda, dev_set)
    shd, _ = twice("sharded_plda_em_iteration",
                   lambda: sharded_plda_em_iteration(mesh, plda, dev_set))
    for f in ("mean", "f", "sigma"):
        check_scaled(f"sharded_plda_em_iteration {f}", getattr(shd, f),
                     getattr(ser, f))
    by_spk = vecs.reshape(N_SPK, UTT_PER_SPK, -1)
    half = UTT_PER_SPK // 2
    enroll, tests = by_spk[:, :half].mean(1), by_spk[:, half:].reshape(-1, R)
    ns = torch.full((N_SPK,), float(half), device=dev)
    s_shd, _ = twice("sharded_plda_llr", lambda: sharded_plda_llr(
        mesh, plda, enroll, ns, tests))
    check_scaled(f"sharded_plda_llr ({N_SPK} models x {len(tests)} tests)",
                 s_shd, plda_llr(plda, enroll, ns, tests))

    # the tools under numThread 4: four shards of the card where the
    # visible-devices function is patched, one device (no mesh) without
    par = os.path.join(workdir, "parallel")
    os.makedirs(par)
    tw_args = chain_args(workdir, par, "", dev.type) + [
        "--inputFeatureFilename", os.path.join(workdir, "world.lst"),
        "--mixtureDistribCount", str(K), "--nbTrainIt", "3",
        "--baggedFrameProbability", "1.0", "--initVarianceFlooring", "0.5",
        "--finalVarianceFlooring", "0.1", "--initVarianceCeiling", "10.0",
        "--finalVarianceCeiling", "10.0", "--randomSeed", "0",
        "--outputWorldFilename", "wld", "--numThread", str(PAR_SHARDS)]
    tv_args = chain_args(workdir, out, "", dev.type) + [
        "--ndxFilename", os.path.join(workdir, "all.ndx"),
        "--inputWorldFilename", "wld", "--totalVariabilityNumber", str(R),
        "--nbIt", "2", "--initScale", "0.01", "--loadAccs", "true",
        "--accsFilename", os.path.join(out, "tv_accs.npz")]

    def tv_tool(name, threads):
        run_tool("TotalVariability", tv_args + [
            "--totalVariabilityMatrix", name, "--meanEstimate",
            name + "mean", "--numThread", str(threads)], {})
        return read_matrix_file(os.path.join(out, name + ".matx"))

    # The blocks cached on the library checks' shard streams (tens of
    # GiB) stay: the tools' new shard threads make their cuSOLVER handles
    # under them (parallel/mesh.py _thread_handles).
    print(f"  parallel: {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB "
          "reserved by PyTorch after the library checks")
    ck.reset_launch_counts()
    t_1 = tv_tool("TVnt1", 1)
    t_4u = tv_tool("TVnt4u", PAR_SHARDS)
    check(np.array_equal(t_4u, t_1), "numThread 4 with one visible device: "
          "no mesh, T equal to numThread 1's to the digit")
    visible = pmesh.visible_devices
    pmesh.visible_devices = lambda kind="cuda": [dev] * PAR_SHARDS
    try:
        (wall, _), c = counted(path, lambda: run_tool("TrainWorld", tw_args,
                                                      {}))
        t_4 = tv_tool("TVnt4", PAR_SHARDS)
    finally:
        pmesh.visible_devices = visible
    check(c["em_stats_fused"] == 3 * PAR_SHARDS and sum(c.values())
          == 3 * PAR_SHARDS, f"TrainWorld numThread {PAR_SHARDS}: K1 "
          f"{PAR_SHARDS} times an EM iteration ({c})")
    llk = {}
    for label, p in (("numThread 1", out), (f"numThread {PAR_SHARDS}",
                                             par)):
        g = GmmDiag.load(os.path.join(p, "wld.gmm"), device=dev)
        llk[label] = float(em_stats_chunked(xf, wf, g).mean_llk())
    print(f"  parallel TrainWorld numThread {PAR_SHARDS} ({wall:.2f} s): "
          f"final UBM meanLLK {llk[f'numThread {PAR_SHARDS}']:.7f}, "
          f"numThread 1 (phase 5) {llk['numThread 1']:.7f}")
    check(abs(llk["numThread 1"] - llk[f"numThread {PAR_SHARDS}"]) <= 1e-4,
          "TrainWorld numThread 4 and 1 agree in meanLLK within 1e-4")
    dt = np.abs(t_4 - t_1)
    print(f"  parallel TotalVariability numThread {PAR_SHARDS}: max|T - T "
          f"numThread 1| {dt.max():.3e} (max|T| {np.abs(t_1).max():.3e})")
    check(bool(np.all(dt <= 2e-4 + 2e-3 * np.abs(t_1))),
          "TotalVariability numThread 4 T within rtol 2e-3, atol 2e-4")

    # the two processes, then the sharded K1 timed against the serial one
    ranks = check_workers(procs, mh_dir, serial[""], dev)
    # where a sharded call's time goes: the four shards' K1 launches one
    # after another on one stream (the card's work), the runtime alone
    # (threads, streams and one psum of a scalar; on four CPU shards, no
    # stream), and the sharded call
    per = xf.shape[0] // PAR_SHARDS
    stats_fn = sharded_stats_fn(mesh)
    one, one_cpu = torch.ones((), device=dev), torch.ones(())
    cpu_mesh = par_mesh(torch.device("cpu"))
    times = {}
    for label, fn in (
            ("serial K1", lambda: ck.em_stats_fused(xf, wf, ubm)),
            (f"{PAR_SHARDS} K1 of {per} frames in turn", lambda: [
                ck.em_stats_fused(xf[i * per:(i + 1) * per],
                                  wf[i * per:(i + 1) * per], ubm)
                for i in range(PAR_SHARDS)]),
            ("mesh.run + psum of a scalar", lambda: mesh.run(
                lambda sh: sh.psum(one))),
            ("the same on 4 CPU shards", lambda: cpu_mesh.run(
                lambda sh: sh.psum(one_cpu))),
            (f"sharded_stats_fn {PAR_SHARDS} x 1", lambda: stats_fn(
                xf, wf, ubm))):
        counted(compare, fn)
        times[label] = statistics.median(
            counted(compare, lambda: cuda_ms(fn))[0] for _ in range(3))
    print("  parallel: at 1M frames, K1 default: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in times.items())
        + " (CUDA events on the caller's stream, median of 3)")
    for kname, kv in kernels.items():
        kv["launches_by_path"]["parallel"] = path[kname]
        kv["launches_by_path"]["parallel-2-processes"] = sum(
            r.get(kname, 0) for r in ranks.values())
        kv["launches"] += path[kname]
        kv["check_launches"] += compare[kname]
    print(f"  parallel: launches {shown(path)}; comparison launches "
          f"{shown(compare)}")


# -- phase 13: the oracle parity run -----------------------------------------

ORACLE_TOL = 1e-3       # per-trial LLR (absolute); i-vectors (of scale)


def run_oracle_parity(kernels, dev) -> None:
    """Phase 13: scripts/torch_oracle_parity.py at scale small on the
    card: the port's CLI chain against the f64 oracle, stage by stage."""
    import torch_oracle_parity as top
    ck.reset_launch_counts()
    res = top.run(temp_dir("lia_chip_smoke_oracle_"), top.SCALES["small"],
                  dev.type, threads=os.cpu_count() or 8)
    launches = dict(ck.launch_counts)
    r = res["results"]
    print(f"  oracle: K={res['shapes']['K']}, D={res['shapes']['D']}, "
          f"R={res['shapes']['R']}, {res['shapes']['n_trials']} trials; "
          "walls s " + ", ".join(f"{k} {v:.2f}"
                                 for k, v in res["wall_s"].items()))
    for line in top.report(r):
        print("  oracle: " + line)
    check(r["score_llr"]["max"] <= ORACLE_TOL,
          f"per-trial LLR within {ORACLE_TOL} of the oracle's")
    check(r["ivector"]["max"] <= ORACLE_TOL * r["ivector_scale"],
          f"i-vectors within {ORACLE_TOL} of the oracle's scale")
    check(launches["em_stats_fused"] > 0 and launches["bw_stats_fused"] > 0,
          f"the parity chain launched K1 and K2 ({shown(launches)})")
    print(f"  oracle: launches {shown(launches)}")
    for kname, kv in kernels.items():
        kv["launches_by_path"]["oracle"] = launches.get(kname, 0)
        kv["launches"] += launches.get(kname, 0)


# -- phase 14: the record drivers --------------------------------------------

# the eer driver's full scale (corpus v3: K=2048, D=39, R=400, PLDA rank
# 150, 300 held-out dev speakers x 10 sessions, 240 target trials) with
# one PLDA seed
MS_EER_SCALE = "full"
MS_PLDA_EER_LIMIT = 0.25        # the full-width eer run's PLDA EER, below


def check_scores(label, stats, n_trials) -> None:
    """Each score file of a record: its trial count, finite scores and
    mean target score above mean impostor score."""
    for name, st in stats.items():
        check(st["n"] == n_trials and st["finite"],
              f"{label} {name}: {st['n']} finite scores of {n_trials}")
        check(st["tgt_mean"] > st["imp_mean"],
              f"{label} {name}: mean target score {st['tgt_mean']:.4f} "
              f"above mean impostor score {st['imp_mean']:.4f}")


def run_milestones(kernels, dev) -> None:
    """Phase 14: the record drivers of scripts/ through the port's tools
    on the card — torch_milestone_eer at full width (default tier, one
    PLDA seed), torch_milestone_jfa at scale small, torch_milestone_plda
    (serial against 8 shards of the card), torch_milestone_adapt and
    torch_milestone_audio — with their checks; each driver's launches
    join ``launches_by_path`` as "milestone-<driver>"."""
    import torch_milestone_adapt as tadapt
    import torch_milestone_audio as taudio
    import torch_milestone_eer as teer
    import torch_milestone_jfa as tjfa
    import torch_milestone_plda as tplda

    recs = {}
    p = teer.SCALES[MS_EER_SCALE]
    rec = recs["eer"] = teer.run(temp_dir("lia_chip_smoke_ms_eer_"), p,
                                 dev.type, plda_seeds=(0,),
                                 scale=MS_EER_SCALE)
    sh, res = rec["shapes"], rec["results"]
    print(f"  milestones: eer ({MS_EER_SCALE}: K={sh['K']}, D={sh['D']}, "
          f"R={sh['R']}, PLDA rank {sh['plda_rank']}, {sh['n_trials']} "
          f"trials, {sh['n_target_trials']} target; dev set "
          f"{sh['n_dev_sessions']} sessions of {sh['n_dev_speakers']} "
          f"speakers): EER raw {100 * res['gmm_raw_eer']:.3f} %, ZT-norm "
          f"{100 * res['gmm_ztnorm_eer']:.3f} %, cosine "
          f"{100 * res['iv_cosine_eer']:.3f} %, PLDA "
          f"{100 * res['iv_plda_eer']:.3f} %")
    # the dev speakers are generator speakers n_spk + n_imp + s, none of
    # them a target or an impostor; no dev session is a trial's file
    check(sh["dev_trial_shared_files"] == 0
          and sh["n_dev_speakers"] == p["n_dev"]
          and sh["n_dev_sessions"] == p["n_dev"] * p["sess"],
          "eer: a held-out dev set of its own speakers")
    check_scores("eer", rec["score_stats"], sh["n_trials"])
    check(res["iv_plda_eer"] < MS_PLDA_EER_LIMIT,
          f"eer: PLDA EER {res['iv_plda_eer']:.4f} below {MS_PLDA_EER_LIMIT}")

    rec = recs["jfa"] = tjfa.run(temp_dir("lia_chip_smoke_ms_jfa_"),
                                 tjfa.SCALES["small"], dev.type,
                                 scale="small")
    print(f"  milestones: jfa (small: K={rec['shapes']['K']}, rank_v "
          f"{rec['shapes']['rank_v']}, rank_u {rec['shapes']['rank_u']}, "
          f"{rec['shapes']['n_trials']} trials): EER "
          f"{100 * rec['results']['jfa_eer']:.3f} %")
    check_scores("jfa", rec["score_stats"], rec["shapes"]["n_trials"])

    rec = recs["plda"] = tplda.run(temp_dir("lia_chip_smoke_ms_plda_"),
                                   tplda.P, dev.type)
    res = rec["results"]
    print(f"  milestones: plda (R={rec['shapes']['R']}, rank "
          f"{rec['shapes']['plda_rank']}, {rec['shapes']['n_trials']} "
          f"trials, {tplda.SHARDS} shards of the card): EER "
          f"{100 * res['plda_eer']:.3f} %; sharded vs serial "
          f"{res['sharded_vs_serial_max_dev']:.3e} "
          f"({res['sharded_vs_serial_rel']:.3e} of scale)")
    check(res["sharded_vs_serial_rel"] <= PAR_TOL,
          f"plda: sharded within {PAR_TOL} of scale of serial")
    check_scores("plda", rec["score_stats"], rec["shapes"]["n_trials"])

    rec = recs["adapt"] = tadapt.run(temp_dir("lia_chip_smoke_ms_adapt_"),
                                     tadapt.P, dev.type)
    res = rec["results"]
    print("  milestones: adapt: EER " + ", ".join(
        f"{k} {100 * res[f'{k}_eer']:.3f} %"
        for k in ("static", "static_znorm", "adapted", "oracle"))
        + f"; second half static {100 * res['static_eer_h2']:.3f} %, "
        f"adapted {100 * res['adapted_eer_h2']:.3f} %")
    check(res["adapted_eer"] <= res["static_eer"],
          "adapt: the WMAP-adapted EER no higher than the static one")

    rec = recs["audio"] = taudio.run(temp_dir("lia_chip_smoke_ms_audio_"),
                                     dev.type)
    res = rec["results"]
    print(f"  milestones: audio: EER {100 * res['audio_eer']:.3f} % over "
          f"{res['n_target_trials']} target / {res['n_impostor_trials']} "
          "impostor trials; verify p50 / p95 ms " + ", ".join(
              f"{k} {v['p50_ms']:.2f} / {v['p95_ms']:.2f}"
              for k, v in rec["verify_latency_ms"].items())
          + f"; TCP verify {res['tcp_verify_wall_ms']:.1f} ms")
    check(res["finite"] and res["tgt_mean"] > res["imp_mean"],
          "audio: finite scores, mean target above mean impostor")

    for name, rec in recs.items():
        print(f"  milestones: {name} walls s " + ", ".join(
            f"{k} {v:.3f}" for k, v in rec["stage_wall_s"].items())
            + f"; launches {rec['launches']}")
    for name in ("eer", "adapt", "audio"):     # the jfa driver's UBM is
        check(recs[name]["launches"].get("em_stats_fused", 0) > 0,  # given
              f"{name}: K1 launched")
    for name in ("eer", "jfa"):
        check(recs[name]["launches"].get("bw_stats_fused", 0) > 0,
              f"{name}: K2 launched")
    for kname, kv in kernels.items():
        for name, rec in recs.items():
            got = rec["launches"].get(kname, 0)
            kv["launches_by_path"][f"milestone-{name}"] = got
            kv["launches"] += got


def cuda_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed_pair(kernel_fn, plain_fn):
    """Median of 3 CUDA-event timings each, after one warm-up call each,
    in turns (plain, kernel, kernel, plain, ...).  Returns (kernel ms,
    plain ms, the kernel's last output, the plain version's last
    output)."""
    last = {}

    def keep(fn, key):
        return lambda: last.__setitem__(key, fn())

    kernel_fn, plain_fn = keep(kernel_fn, "kernel"), keep(plain_fn, "plain")
    kernel_fn(), plain_fn()
    ks, ps = [], []
    for i in range(3):
        order = ((plain_fn, ps), (kernel_fn, ks))
        for fn, out in (order if i % 2 == 0 else order[::-1]):
            out.append(cuda_ms(fn))
    return (statistics.median(ks), statistics.median(ps), last["kernel"],
            last["plain"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    device_name = torch.cuda.get_device_name(0)
    print(f"device: {device_name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    phase("device", t0)

    # 2. build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        # one nvcc per source and one g++ per native source (the feature
        # reader, the parity oracle), side by side; a failed build raises
        host = [pool.submit(_build.host_build, name)
                for name in _build.GXX_FLAGS]
        list(pool.map(_build.library, _build.SOURCES))
        host = [f.result() for f in host]
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, "
          "side by side: " + ", ".join(
              f"{k} {v:.1f} s" for k, v in _build.build_times.items())
          + "; gmm_stats is the tiers' library, the one the main paths "
          "load)" if _build.build_times
          else "kernels: libraries already built")
    print("native builds: " + ", ".join(p.name for p in host))
    phase("build", t0)

    # every arithmetic of K1 and K2; launches of the arithmetics beyond
    # the tiers stay 0 unless a tool reaches one
    kernels = {entry(k, m.name): {"name": entry(k, m.name), "route": "cuda",
                                  "source": SOURCE, "replaces": REPLACES[k],
                                  "launches": 0, "check_launches": 0}
               for k in REPLACES for m in ck.all_modes()}

    # 3. the slice at full width
    t0 = time.perf_counter()
    xu, mask = corpus(np.random.default_rng(0), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    init = mixture_init(gen, xu.reshape(-1, D), mask.reshape(-1), K)
    tv_t = init_t(torch.Generator(device=dev).manual_seed(2), R, init,
                  scale=0.01).t
    torch.cuda.synchronize()
    print(f"  corpus {tuple(xu.shape)} ({mask.sum().item():.0f} weighted "
          f"frames), init K={K}, T {tuple(tv_t.shape)}")
    ck.reset_launch_counts()
    t1 = time.perf_counter()
    ubm, bw, wv, scores, target, llks = run_slice(xu, mask, init, tv_t,
                                                  fused=True)
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t1
    launches = dict(ck.launch_counts)
    print(f"  slice (kernels) {slice_s:.2f} s; launches {shown(launches)}")
    print("  meanLLK per EM iteration (last = final UBM): "
          + ", ".join(f"{v:.5f}" for v in llks))
    for a, b in zip(llks, llks[1:]):
        check(b >= a - 1e-3, f"meanLLK decreased: {llks}")
    for label, v in (("weights", ubm.weights), ("means", ubm.means),
                     ("cov_inv", ubm.cov_inv), ("bw n", bw.n),
                     ("bw f", bw.f), ("i-vectors", wv), ("scores", scores)):
        check(bool(torch.isfinite(v).all()), f"{label} finite")
    check(wv.shape == (N_SPK * UTT_PER_SPK, R), "i-vector shape")
    for kname in REPLACES:
        check(launches[kname] > 0, f"{kname} launched in the slice")
    sc = scores.cpu().numpy()
    tg = target.cpu().numpy()
    print(f"  cosine EER {100 * eer(sc[tg], sc[~tg]):.2f} % over "
          f"{tg.sum()} target / {(~tg).sum()} impostor trials")
    _, _, wp, _, _, llks_p = run_slice(xu, mask, init, tv_t, fused=False)
    dw = float((wv - wp).abs().max())
    wmax = float(wv.abs().max())
    print(f"  plain-path rerun: meanLLK {', '.join(f'{v:.5f}' for v in llks_p)}"
          f"; max|dw| {dw:.3e} vs max|w| {wmax:.3e}")
    check(dw <= 1e-3 * wmax, "kernel and plain i-vectors agree")
    phase("slice", t0)

    # 4. K1 and K2 against their plain versions in every tier, timed
    t0 = time.perf_counter()
    run_tiers(xu, mask, ubm, kernels)
    phase("tiers", t0)

    # 5. the CLI chain at full width, default tier and fastStats
    t0 = time.perf_counter()
    lens = mask.sum(1).to(torch.int64).cpu().numpy()
    xu_np = xu.cpu().numpy()
    workdir = temp_dir("lia_chip_smoke_")
    lists = write_corpus(workdir, xu_np, lens)
    chains = {}
    for tier in ("", "fastStats"):
        ck.reset_launch_counts()
        tnative.reset_read_counts()
        chains[tier] = run_cli_chain(workdir, lists, tier)
        chains[tier]["launches"] = dict(ck.launch_counts)
        check_native_reads(f"chain [{tier or 'default'}]")
    # the fastMath key reaches K1 through TrainWorld only (no tool
    # passes it to K2): TrainWorld alone in both fastMath tiers
    fm_runs = {}
    for tier in ("fastMath", "fastMath+fastStats"):
        ck.reset_launch_counts()
        fm_runs[tier] = run_cli_chain(workdir, lists, tier,
                                      tools=("TrainWorld",))
        fm_runs[tier]["launches"] = dict(ck.launch_counts)

    def final_llk(label, res):
        """The chain UBM's corpus meanLLK (default-tier plain stats),
        after the per-iteration meanLLK are checked non-decreasing."""
        chain_ubm = GmmDiag.load(os.path.join(workdir, label, "wld.gmm"),
                                 device=dev)
        v = float(ck.em_stats_reference(
            xu.reshape(-1, D), mask.reshape(-1), chain_ubm).mean_llk())
        llks = res["llks"] + [v]
        print(f"  chain [{label}]: meanLLK per EM iteration (last = "
              "final UBM): " + ", ".join(f"{u:.5f}" for u in llks))
        check(len(res["llks"]) == 3, f"{label}: 3 EM iterations seen")
        for a, b in zip(llks, llks[1:]):
            check(b >= a - 1e-3, f"{label} meanLLK decreased: {llks}")
        wall = sum(res["walls"].values())
        kms = res["kernel_ms"]
        print(f"  chain [{label}]: tool wall s " + ", ".join(
            f"{k} {u:.3f}" for k, u in res["walls"].items())
            + "; kernel device ms " + ", ".join(
            f"{k} {u:.2f}" for k, u in kms.items())
            + f" ({100 * sum(kms.values()) / 1e3 / wall:.2f} % of "
            f"{wall:.3f} s)")
        return v

    final = {}
    for tier, res in chains.items():
        label = tier or "default"
        launches = res["launches"]
        print(f"  chain [{label}]: launches {shown(launches)}")
        # K1: 3 EM iterations; K2: 8 batches in each of
        # TotalVariability and IvExtractor
        for kname, count in (("em_stats_fused", 3),
                             ("bw_stats_fused", 16)):
            key = entry(kname, tier)
            check(launches[key] == count, f"{key} launched {count} "
                  f"times in the {label} chain ({launches[key]})")
            kernels[key]["launches"] = launches[key]
            if tier:
                check(launches[kname] == 0,
                      f"default {kname} not launched in the {label} "
                      "chain")
        scores = res["scores"]
        check(len(scores) == N_SPK * N_SPK * (UTT_PER_SPK // 2),
              f"{label} score file has 12,500 lines")
        sc = np.array([r.score for r in scores])
        check(bool(np.isfinite(sc).all()), f"{label} scores finite")
        tgt = np.array([r.model.split("_")[0] == r.seg.split("_")[0]
                        for r in scores])
        print(f"  chain [{label}]: cosine EER "
              f"{100 * eer(sc[tgt], sc[~tgt]):.2f} % over {tgt.sum()} "
              f"target / {(~tgt).sum()} impostor trials")
        final[tier] = final_llk(label, res)
    for tier, res in fm_runs.items():
        launches = res["launches"]
        key = entry("em_stats_fused", tier)
        print(f"  TrainWorld [{tier}]: launches {shown(launches)}")
        check(launches[key] > 0, f"{key} launched by TrainWorld")
        check(all(v == 0 for k, v in launches.items() if k != key),
              f"only {key} launched by TrainWorld [{tier}]")
        kernels[key]["launches"] = launches[key]
        final[tier] = final_llk(tier, res)
        # bf16 logits move occupancies by percents (the JAX suite's
        # own fastMath EM budget is 5e-3 at toy size)
        dl = abs(final[tier] - final[""])
        print(f"  final UBM meanLLK {tier} {final[tier]:.7f} (|diff| to "
              f"default {dl:.2e})")
        check(dl <= 5e-2, f"{tier} and default final UBM meanLLK within "
              "5e-2 nats/frame")
    for tier in fm_runs:        # no tool passes fastMath to K2
        kernels[entry("bw_stats_fused", tier)]["launches"] = 0
    for m in ck.all_modes()[4:]:    # no tool reaches these arithmetics
        for kname in REPLACES:
            key = entry(kname, m.name)
            kernels[key]["launches"] = sum(
                res["launches"][key]
                for res in (*chains.values(), *fm_runs.values()))
    dl = abs(final[""] - final["fastStats"])
    print(f"  final UBM meanLLK default {final['']:.7f}, fastStats "
          f"{final['fastStats']:.7f} (|diff| {dl:.2e})")
    ubms = [GmmDiag.load(os.path.join(workdir, t or "default",
                                      "wld.gmm")) for t in chains]
    print("  default vs fastStats UBM: max|diff| " + ", ".join(
        f"{f} {float((getattr(ubms[0], f) - getattr(ubms[1], f)).abs().max()):.3e}"
        for f in ("weights", "means", "cov_inv")))
    check(dl <= 1e-2, "default and fastStats chains' final UBM meanLLK "
          "within 1e-2 nats/frame")
    phase("cli", t0)

    # 6. the GMM-UBM system of configs 1 and 2 at full width
    t0 = time.perf_counter()
    gu_dir, gu_lists, raw_eer = run_gmm_ubm(kernels, dev)
    phase("gmm-ubm", t0)

    # 7. the i-vector back end of configs 3 and 5, on phase 5's chain
    t0 = time.perf_counter()
    run_backend(workdir, lists, kernels, dev)
    phase("backend", t0)

    # 8. the JFA system of config 4, on phase 6's features and models
    t0 = time.perf_counter()
    run_jfa(gu_dir, gu_lists, raw_eer, kernels, dev)
    phase("jfa", t0)

    # 9. diarization at the milestone shape, and the Viterbi kernel
    t0 = time.perf_counter()
    diar_dir, diar_frames = run_diarization(kernels, dev)
    phase("diar", t0)

    # 10. the serving API at full width, the audio path, SpkAdapt
    t0 = time.perf_counter()
    run_serving(gu_dir, gu_lists, kernels, dev)
    phase("serving", t0)

    # 11. the GMM-supervector SVM system and the other utility tools, on
    # phase 6's world, features, models and trials; the SVM dual kernel
    t0 = time.perf_counter()
    run_gmm_svm(gu_dir, gu_lists, diar_dir, diar_frames, kernels, dev)
    phase("gmm-svm", t0)

    # 12. numThread: meshes of shards of the card against the serial
    # functions, the tools with numThread 4, two processes under gloo
    t0 = time.perf_counter()
    run_parallel(xu, mask, workdir, gu_dir, gu_lists, kernels, dev)
    phase("parallel", t0)

    # 13. the port's chain against the f64 oracle at scale small
    t0 = time.perf_counter()
    run_oracle_parity(kernels, dev)
    phase("oracle", t0)

    # 14. the record drivers: eer at full width, jfa, plda, adapt, audio
    t0 = time.perf_counter()
    run_milestones(kernels, dev)
    phase("milestones", t0)

    print(smi[0])
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
