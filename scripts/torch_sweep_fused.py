"""Sweep of K1's arithmetic on the card: Mframe/s and the occupancy error
against a float64 oracle for every mode of ``em_stats_fused``, at K=2048,
D=39, 1M frames.

The counterpart of scripts/sweep_fused.py (the JAX package's sweep, which
chose the tiers on a TPU v5e): the same problem from the same numpy draws
(x standard normal, w = 1, random means, cov_inv in [0.5, 1.5), weights
1/K), the same rows with ``chunk`` in the place of ``block``, then every
other mode the kernel takes (``cuda_kernels.all_modes``).  Each row times
the kernel with CUDA events (median of 3 after one warm-up call) and
gives the largest relative occupancy error, max_k |n_k - n64_k| /
(n64_k + 1e-9), against the float64 oracle on the first 65,536 frames.
The plain f32 stats path (``kernels.em_stats_chunked``) is timed beside
the kernels as information: it is not a kernel of the port.

    python3 scripts/torch_sweep_fused.py [--trace DIR]

Needs a CUDA card; prints the card's name and power limit first.
``--trace DIR`` writes a torch.profiler trace with one named span a row.
Run alone; importing it runs nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

K, D, N = 2048, 39, 1_000_000
NS = 65536                      # frames of the float64 oracle


def make_problem(device, n: int = N, seed: int = 0):
    """x (n, D), w (n,) and the GMM of the JAX sweep, from its draws."""
    from lia_ral_tpu_torch.convert import gmm_from_numpy

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    means = rng.standard_normal((K, D)).astype(np.float32)
    cov_inv = (rng.random((K, D)) + 0.5).astype(np.float32)
    weights = np.full(K, 1.0 / K, np.float32)
    return (torch.from_numpy(x).to(device), torch.ones(n, device=device),
            gmm_from_numpy(weights, means, cov_inv, device))


def f64_occupancy(x, w, gmm, chunk: int = 8192) -> torch.Tensor:
    """n_k = sum_t w_t gamma_tk in float64 on x's device, ``chunk`` frames
    at a time (the last axis of x is D; leading axes are summed over all
    but the first when x is 3-D, which gives per-utterance occupancies)."""
    ci = gmm.cov_inv.double()
    mi = gmm.means.double() * ci
    cst = (-0.5 * (gmm.dim * np.log(2 * np.pi) - torch.log(ci).sum(-1))
           - 0.5 * (gmm.means.double() * mi).sum(-1)
           + torch.log(gmm.weights.double()))
    lead = x.shape[:-1]
    xf, wf = x.reshape(-1, x.shape[-1]), w.reshape(-1)
    rows = []
    for s0 in range(0, xf.shape[0], chunk):
        xc = xf[s0:s0 + chunk].double()
        ld = -0.5 * (xc * xc) @ ci.T + xc @ mi.T + cst
        g = torch.softmax(ld, dim=-1) * wf[s0:s0 + chunk].double()[:, None]
        rows.append(g)
    g = torch.cat(rows).reshape(*lead, -1)
    return g.sum(dim=-2) if x.dim() == 3 else g.sum(dim=0)


def n_rel_err(n, n64) -> float:
    """The JAX sweep's accuracy figure: max |n - n64| / (n64 + 1e-9)."""
    return float(((n.double() - n64).abs() / (n64 + 1e-9)).max())


def cuda_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed(fn, reps: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings after one warm-up call, ms."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(fn) for _ in range(reps))


def rows() -> list[tuple[str, dict]]:
    """(tag, em_stats_fused keyword arguments): the JAX sweep's rows, then
    every other mode once."""
    from lia_ral_tpu_torch.gmm import cuda_kernels as ck

    bf16 = torch.bfloat16
    out = [
        ("fused default chunk auto", {}),
        ("fused default chunk 2048", dict(chunk=2048)),
        ("fused bf16 (fastMath) chunk auto", dict(compute_dtype=bf16)),
        ("fused bf16 (fastMath) chunk 2048",
         dict(compute_dtype=bf16, chunk=2048)),
        ("fused f32-HIGH chunk 2048", dict(mxu_precision="high",
                                           chunk=2048)),
        ("fused f32-HIGH chunk auto", dict(mxu_precision="high")),
        ("r3 fastStats bf16nx", dict(stats_pass="bf16nx")),
        ("r3 bf16 1-pass stats", dict(stats_pass="bf16")),
        ("r3 exp (natural) x3", dict(exp_mode="exp")),
        ("r3 fast2 software exp", dict(exp_mode="fast2")),
        ("r3 bf16sr stats", dict(stats_pass="bf16sr")),
    ]
    seen = {ck.check_mode(**{k: v for k, v in kw.items() if k != "chunk"})
            for _, kw in out}
    for mode in ck.all_modes():
        if mode not in seen:
            out.append((f"mode {mode.name}", mode.kwargs()))
    return out


def bench(tag, fn, x, w, n64, span=contextlib.nullcontext):
    """Prints and returns (Mframe/s, n rel-err) of fn(x, w) -> EmStats."""
    with span(tag):
        err = n_rel_err(fn(x[:NS], w[:NS]).n, n64)
        ms = timed(lambda: fn(x, w))
    rate = x.shape[0] / ms / 1e3
    print(f"{tag:52s} {rate:8.1f} Mframe/s  {ms:8.3f} ms   n-relerr "
          f"{err:.2e}", flush=True)
    return rate, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", help="write a torch.profiler trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sweep_fused: no CUDA card", file=sys.stderr)
        return 1
    from lia_ral_tpu_torch.gmm import cuda_kernels as ck
    from lia_ral_tpu_torch.gmm.kernels import em_stats_chunked
    from lia_ral_tpu_torch.utils.logging import profile_trace, span

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    x, w, gmm = make_problem(dev)
    n64 = f64_occupancy(x[:NS], w[:NS], gmm)
    trace = (profile_trace(args.trace) if args.trace
             else contextlib.nullcontext())
    with trace:
        for tag, kw in rows():
            bench(tag, lambda a, b, kw=kw: ck.em_stats_fused(a, b, gmm,
                                                             **kw),
                  x, w, n64, span)
        bench("plain f32 em_stats_chunked (information)",
              lambda a, b: em_stats_chunked(a, b, gmm, chunk=16384),
              x, w, n64, span)
    return 0


if __name__ == "__main__":
    sys.exit(main())
