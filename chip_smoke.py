#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lia_ral_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (nvcc).  The script imports nothing of JAX.  Phases, each
printed as it ends; any failure raises and the exit code is non-zero:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds the kernels of csrc/ into the ignored build dir
3. K1       em_stats_fused against its plain version, K=2048, D=39,
            65,536 frames, ~5 % zero-weight frames
4. K2       bw_stats_fused against its plain version, K=2048, D=39,
            S=64 × T=2000, plus T=2060 and T=61, ragged masks
5. slice    the main path at full width on a synthetic corpus (1M frames
            = 10,000 audio-s, 500 utterances × 2000 frames, 50 speakers):
            mixture_init → train_model (K=2048, 3 EM iterations) →
            bw_stats_batch → init_t (R=400) → estimate_w (PCG) →
            cosine_scores → eer.  Checks finite outputs, meanLLK
            non-decreasing within 1e-3 nats/frame, both kernels launched,
            and the i-vectors of a rerun through the plain stats paths
            from the same init within 1e-3·max|w|.
6. timing   each kernel and its plain version at the slice's shapes,
            CUDA events, median of 3 after warm-up

The line before the last is one JSON object of per-kernel results; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import lia_ral_tpu_torch  # noqa: F401  (numerics pin: TF32 off)
from lia_ral_tpu_torch import _build
from lia_ral_tpu_torch.backend.eval import eer
from lia_ral_tpu_torch.backend.scoring import cosine_scores
from lia_ral_tpu_torch.convert import gmm_from_numpy
from lia_ral_tpu_torch.fa.stats import bw_stats_batch
from lia_ral_tpu_torch.fa.tv import TvModel, estimate_w, init_t
from lia_ral_tpu_torch.gmm import cuda_kernels as ck
from lia_ral_tpu_torch.gmm.em import (TrainCfg, default_stats_fn,
                                      mixture_init, train_model)
from lia_ral_tpu_torch.gmm.kernels import em_stats_chunked

K, D, R = 2048, 39, 400
N_SPK, UTT_PER_SPK, T_UTT = 50, 10, 2000
SOURCE = "lia_ral_tpu_torch/csrc/gmm_stats.cu"
REPLACES = {"em_stats_fused": "lia_ral_tpu/gmm/pallas_kernels.py:314",
            "bw_stats_fused": "lia_ral_tpu/gmm/pallas_kernels.py:476"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name: str, t0: float) -> None:
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def random_gmm(rng, k, d, device):
    w = rng.random(k) + 0.5
    return gmm_from_numpy(w / w.sum(), rng.standard_normal((k, d)),
                          rng.random((k, d)) + 0.5, device)


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


def ragged_mask(rng, s, t, device):
    lens = rng.integers(t // 2, t + 1, s)
    m = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    m *= (rng.random((s, t)) > 0.05)           # scattered zero weights
    m[-1] = 0.0                                 # one all-zero utterance
    return torch.from_numpy(m.astype(np.float32)).to(device)


def corpus(rng, device):
    """Speaker-shifted frames of a 64-component GMM, (S, T, D), with a
    ragged tail masked per utterance."""
    s = N_SPK * UTT_PER_SPK
    centers = rng.standard_normal((64, D)).astype(np.float32) * 2.0
    shifts = rng.standard_normal((N_SPK, D)).astype(np.float32) * 0.05
    comp = rng.integers(0, 64, (s, T_UTT))
    x = rng.standard_normal((s, T_UTT, D), dtype=np.float32)
    x += centers[comp]
    x += np.repeat(shifts, UTT_PER_SPK, axis=0)[:, None, :]
    lens = T_UTT - rng.integers(0, 200, s)
    mask = (np.arange(T_UTT)[None, :] < lens[:, None]).astype(np.float32)
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


def cuda_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed_pair(kernel_fn, plain_fn) -> tuple[float, float]:
    """Median of 3 CUDA-event timings each, after one warm-up call each,
    in turns (plain, kernel, kernel, plain, ...)."""
    kernel_fn(), plain_fn()
    ks, ps = [], []
    for i in range(3):
        order = ((plain_fn, ps), (kernel_fn, ks))
        for fn, out in (order if i % 2 == 0 else order[::-1]):
            out.append(cuda_ms(fn))
    return statistics.median(ks), statistics.median(ps)


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
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    phase("device", t0)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built by nvcc in {_build.build_seconds:.1f} s"
          if _build.build_seconds is not None
          else "kernels: library already built")
    phase("build", t0)

    rng = np.random.default_rng(0)
    kernels = {n: {"name": n, "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES[n]} for n in REPLACES}

    # 3. K1 vs its plain version
    t0 = time.perf_counter()
    gmm = random_gmm(rng, K, D, dev)
    n = 65536
    x = torch.from_numpy(rng.standard_normal((n, D), dtype=np.float32)
                         ).to(dev)
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0.0
    w = torch.from_numpy(w).to(dev)
    got = ck.em_stats_fused(x, w, gmm)
    torch.cuda.synchronize()
    want = ck.em_stats_reference(x, w, gmm)
    err = check_stats("K1", [("n", got.n, want.n, 1e-4),
                             ("sum_x", got.sum_x, want.sum_x, 1e-3),
                             ("sum_xx", got.sum_xx, want.sum_xx, 1e-3)],
                      (got.llk[None], want.llk[None]))
    check(abs(float(got.count) - float(want.count))
          <= 1e-6 * float(want.count), "K1 count")
    kernels["em_stats_fused"]["max_abs_err"] = err
    phase("K1 vs plain", t0)

    # 4. K2 vs its plain version
    t0 = time.perf_counter()
    worst = 0.0
    for s, t in ((64, 2000), (8, 2060), (16, 61)):
        xs = torch.from_numpy(rng.standard_normal((s, t, D),
                                                  dtype=np.float32)).to(dev)
        ms = ragged_mask(rng, s, t, dev)
        n_k, f_k, l_k = ck.bw_stats_fused(xs, ms, gmm)
        torch.cuda.synchronize()
        n_p, f_p, l_p = ck.bw_stats_reference(xs, ms, gmm)
        worst = max(worst, check_stats(
            f"K2 S={s} T={t}", [("n", n_k, n_p, 1e-4), ("f", f_k, f_p, 1e-3)],
            (l_k, l_p)))
        check(bool((n_k[-1] == 0).all() and (f_k[-1] == 0).all()),
              "K2 all-zero-weight utterance gives n = f = 0")
    kernels["bw_stats_fused"]["max_abs_err"] = worst
    del xs, ms, x, w
    phase("K2 vs plain", t0)

    # 5. the slice at full width
    t0 = time.perf_counter()
    xu, mask = corpus(rng, dev)
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
    print(f"  slice (kernels) {slice_s:.2f} s; launches {launches}")
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
        kernels[kname]["launches"] = launches[kname]
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

    # 6. timing at the slice's shapes
    t0 = time.perf_counter()
    xf, wf = xu.reshape(-1, D), mask.reshape(-1)
    k_ms, p_ms = timed_pair(lambda: ck.em_stats_fused(xf, wf, ubm),
                            lambda: ck.em_stats_reference(xf, wf, ubm))
    kernels["em_stats_fused"].update(ms=k_ms, plain_ms=p_ms)
    k_ms, p_ms = timed_pair(lambda: ck.bw_stats_fused(xu, mask, ubm),
                            lambda: ck.bw_stats_reference(xu, mask, ubm))
    kernels["bw_stats_fused"].update(ms=k_ms, plain_ms=p_ms)
    for kname, kv in kernels.items():
        print(f"  {kname}: kernel {kv['ms']:.3f} ms, plain "
              f"{kv['plain_ms']:.3f} ms (N={xf.shape[0]} frames, K={K}, "
              f"D={D})")
    phase("timing", t0)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
