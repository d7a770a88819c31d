#!/usr/bin/env python3
"""Device time of each CUDA kernel inside K1 and K2 of the PyTorch port.

    python3 scripts/torch_kernel_profile.py [--frames 1000000] [--k 2048]
                                            [--dim 39] [--utt-len 2000]
                                            [--registers]

Run from the root of a checkout on a machine with one CUDA card and nvcc.
Prints the card's name and power limit, builds the kernels (with
--registers it first compiles the source once more with ``-Xptxas -v``
into a temporary directory and prints each kernel's registers and
spills), then for every tier prints the mean device time of each
kernel of one `em_stats_fused` call (prep, llk pass, tiles, stats pass,
chunk reduce) and one `bw_stats_fused` call, from `torch.profiler` over
three calls after a warm-up, and the time per call of a loop of calls
between two CUDA events.  Inputs are random, made from seed 0.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lia_ral_tpu_torch import _build  # noqa: E402
from lia_ral_tpu_torch.convert import gmm_from_numpy  # noqa: E402
from lia_ral_tpu_torch.gmm import cuda_kernels as ck  # noqa: E402

TIERS = {"default": (None, "x3"), "fastStats": (None, "bf16nx"),
         "fastMath": (torch.bfloat16, "x3"),
         "fastMath+fastStats": (torch.bfloat16, "bf16nx")}


def kernel_times(fn, calls: int = 3) -> dict[str, float]:
    """Mean device ms per call of each kernel that ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("::")[-1].split("(")[0]: e.device_time_total / calls / 1e3
            for e in prof.key_averages() if "kernel" in e.key}


def loop_ms(fn, calls: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def print_registers() -> None:
    """ptxas's report of registers and spills per kernel, from a build of
    its own with the flags of the every-mode library (every instance);
    the library it writes is dropped."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.nvcc(), *_build.nvcc_flags("gmm_stats_modes"),
               "-Xptxas", "-v", "-o",
               os.path.join(tmp, "scratch.so"), str(_build.SOURCE)]
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             check=True).stdout
    for line in out.splitlines():
        if "Compiling" in line or "Used" in line or "spill" in line:
            print(line[:160])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--dim", type=int, default=39)
    ap.add_argument("--utt-len", type=int, default=2000)
    ap.add_argument("--registers", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.registers:
        print_registers()
    _build.library()
    print(f"build s {_build.build_times}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    wts = rng.random(args.k) + 0.5
    gmm = gmm_from_numpy(wts / wts.sum(),
                         rng.standard_normal((args.k, args.dim)),
                         rng.random((args.k, args.dim)) + 0.5, dev)
    n_utt = max(args.frames // args.utt_len, 1)
    xu = torch.randn((n_utt, args.utt_len, args.dim), device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
    wu = torch.ones((n_utt, args.utt_len), device=dev)
    xf, wf = xu.reshape(-1, args.dim), wu.reshape(-1)
    print(f"K1: N={xf.shape[0]} K={args.k} D={args.dim}; "
          f"K2: {n_utt} x {args.utt_len}")
    for tier, (cdt, sp) in TIERS.items():
        for name, fn in (
                ("em_stats_fused", lambda: ck.em_stats_fused(
                    xf, wf, gmm, compute_dtype=cdt, stats_pass=sp)),
                ("bw_stats_fused", lambda: ck.bw_stats_fused(
                    xu, wu, gmm, compute_dtype=cdt, stats_pass=sp))):
            per_kernel = kernel_times(fn)
            print(f"{name}[{tier}]: {loop_ms(fn):.3f} ms a call; kernels "
                  + ", ".join(f"{k} {v:.3f}" for k, v in per_kernel.items())
                  + f" (sum {sum(per_kernel.values()):.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
