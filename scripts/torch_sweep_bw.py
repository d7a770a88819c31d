"""Sweep of K2's arithmetic on the card: Mframe/s and the occupancy error
against a float64 oracle for every mode of ``bw_stats_fused``, at
S=500 utterances x T=2000 frames, K=2048, D=39.

The counterpart of scripts/sweep_bw.py (the JAX package's sweep on a TPU
v5e): the same problem from the same numpy draws (the frames of
scripts/torch_sweep_fused.py in utterances), its EM-kernel-flat anchor
(K1 on the same frames, flat) and its "+chain" rows (each call's input
shifted by 1e-9 of the last call's first occupancy, so that no call can
start before the last one ended), then every mode K2 takes
(``cuda_kernels.all_modes``).  K2 has no ``block``: one CTA owns an
utterance's frames, so the JAX sweep's block rows have no counterpart.
Each row times the kernel with CUDA events (median of 3 after a warm-up
call) and gives max |n - n64| / (n64 + 1e-9) over the first 16
utterances against the float64 oracle.  ``chip_smoke.py`` times the
plain version (``bw_stats_reference``) of each tier beside its kernel.

    python3 scripts/torch_sweep_bw.py [--trace DIR]

Needs a CUDA card; prints the card's name and power limit first.
Run alone; importing it runs nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch

import torch_sweep_fused as fused

K, D, S, T = fused.K, fused.D, 500, 2000
NS = 16                         # utterances of the float64 oracle


def make_problem(device, s: int = S, t: int = T, seed: int = 0):
    """x (s, t, D), w (s, t) and the GMM of the JAX sweep, from its draws
    (the same values as ``torch_sweep_fused.make_problem`` at n = s t)."""
    x, w, gmm = fused.make_problem(device, s * t, seed)
    return x.reshape(s, t, D), w.reshape(s, t), gmm


def rows() -> list[tuple[str, dict, bool]]:
    """(tag, bw_stats_fused keyword arguments, chained): the JAX sweep's
    rows that have a counterpart, then every other mode once."""
    from lia_ral_tpu_torch.gmm import cuda_kernels as ck

    out = [("bw default x3", {}, False),
           ("bw default x3 +chain", {}, True),
           ("bw bf16nx (fastStats)", dict(stats_pass="bf16nx"), False),
           ("bw bf16nx +chain", dict(stats_pass="bf16nx"), True),
           ("bw bf16", dict(stats_pass="bf16"), False)]
    seen = {ck.check_mode(**kw) for _, kw, _ in out}
    for mode in ck.all_modes():
        if mode not in seen:
            out.append((f"bw mode {mode.name}", mode.kwargs(), False))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", help="write a torch.profiler trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sweep_bw: no CUDA card", file=sys.stderr)
        return 1
    from lia_ral_tpu_torch.gmm import cuda_kernels as ck
    from lia_ral_tpu_torch.utils.logging import profile_trace, span

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    x, w, gmm = make_problem(dev)
    n64 = fused.f64_occupancy(x[:NS], w[:NS], gmm)
    trace = (profile_trace(args.trace) if args.trace
             else contextlib.nullcontext())
    n_frames = S * T
    with trace:
        for tag, kw in (("EM-kernel flat x3 (anchor)", {}),
                        ("EM-kernel flat bf16nx",
                         dict(stats_pass="bf16nx"))):
            with span(tag):
                ms = fused.timed(lambda kw=kw: ck.em_stats_fused(
                    x.reshape(-1, D), w.reshape(-1), gmm, **kw))
            print(f"{tag:52s} {n_frames / ms / 1e3:8.1f} Mframe/s  "
                  f"{ms:8.3f} ms", flush=True)
        for tag, kw, chain in rows():
            state = {"shift": torch.zeros((), device=dev)}

            def call(kw=kw, chain=chain):
                xx = x + state["shift"] if chain else x
                n, _, _ = ck.bw_stats_fused(xx, w, gmm, **kw)
                state["shift"] = n[0, 0] * 1e-9
                return n
            with span(tag):
                n, _, _ = ck.bw_stats_fused(x[:NS], w[:NS], gmm, **kw)
                err = fused.n_rel_err(n, n64)
                ms = fused.timed(call)
            print(f"{tag:52s} {n_frames / ms / 1e3:8.1f} Mframe/s  "
                  f"{ms:8.3f} ms   n-relerr {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
