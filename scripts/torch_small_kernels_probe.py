#!/usr/bin/env python3
"""Registers, SASS, clock probes and times of the port's two kernels that
no TPU kernel stands behind: the Viterbi decoder (``csrc/viterbi.cu``)
and the SVM dual solver (``csrc/svm_dual.cu``).

    python3 scripts/torch_small_kernels_probe.py [--out chiprun_out/probe]
        [--viterbi-baseline OLD.cu] [--svm-baseline OLD.cu]
        [--viterbi-n 30000,60000] [--svm-n 55,1001,4096] [--skip-svm]

Run from the root of a checkout on a machine with one CUDA card and nvcc.
Prints the card's name and power limit, then for each source (the tree's,
and a baseline of an earlier design where one is given, bound with that
design's C signature):

- ptxas's registers, stack frame, spills and shared memory per kernel
  (its own ``-Xptxas -v`` build into a temporary directory);
- instruction counts per kernel from ``cuobjdump -sass`` (total, local
  memory LDL/STL, shuffles, barriers); the whole listing is written to
  ``--out``;
- for the Viterbi sources, variants built from a patched copy (the
  tree is not touched): one that stops after the forward recursion, and
  one that reads ``clock64()`` at the kernel's start, at the end of the
  forward recursion and at its end (the lines ``// probe: ...`` mark the
  places; a baseline without them gets them at its known anchors).  It
  prints SM cycles a forward step and the backtrace's share, and the
  forward's cycles a step without the delta's store and without the
  emission's load (``STEP_VARIANTS``);
- for the tree's SVM source, a variant that sums ``clock64()`` over the
  FISTA steps of block 0's thread 0 (the ``// probe:`` lines of its
  loop): SM cycles a step in the vector's publication and the matvec,
  and in the projection;
- CUDA-event times (median of 3, after a warm-up) at the given shapes,
  in turns (baseline, tree, tree, baseline), and for the SVM a FISTA
  step's cost as (t(500 steps) - t(0 steps)) / 500;
- the latency in SM cycles of the instructions on these kernels' chains
  (a dependent chain of 1024 of each: SHFL.IDX, FFMA, FMNMX, LDS, a
  __syncthreads of 4 warps, a cluster barrier of 2 and 16 blocks, a
  warp's exchange through shared memory), from a small source of its
  own.

Inputs are random, made from seed 0.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lia_ral_tpu_torch import _build  # noqa: E402
from lia_ral_tpu_torch.backend import svm as tsvm  # noqa: E402
from lia_ral_tpu_torch.seg import hmm  # noqa: E402

# the places a Viterbi source marks, and where the design of PRs 6-9
# (which has no marks) gets them
MARKS = ("// probe: kernel begins", "// probe: forward ends",
         "// probe: kernel ends")
OLD_ANCHORS = {
    "    const int j = threadIdx.x;\n":
        "    const int j = threadIdx.x;\n    // probe: kernel begins\n",
    "    __syncthreads();               // back pointers and s_last are "
    "visible\n":
        "    // probe: forward ends\n    __syncthreads();\n",
    "        __syncthreads();\n    }\n}\n":
        "        __syncthreads();\n    }\n    // probe: kernel ends\n}\n",
}
PROBE_DECL = "\n__device__ long long lia_probe_clk[2];\n"
# clock variants of a step of the tree's Viterbi source (paths no longer
# right): without the delta's store, and with a constant for the
# emission's shared-memory load
STEP_VARIANTS = {
    "no-store": ("                deltas[off] = delta;\n",
                 "                if (delta == -12345.f) deltas[off] = 0.f;\n"),
    "no-emission-load": ("const float e = slot[u * S + jc];",
                         "const float e = 1e-3f * u;"),
}
PROBE_READ = ('\nextern "C" int lia_probe_read(long long* out) {\n'
              "    return (int)cudaMemcpyFromSymbol(out, lia_probe_clk, "
              "2 * sizeof(long long));\n}\n")


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build(src: Path, out: Path) -> str:
    """nvcc with the package's flags and -Xptxas -v; ptxas's report."""
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(out), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}")
    return proc.stdout


def print_ptxas(label: str, report: str) -> None:
    fn = "?"
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        elif "Used" in line or "spill" in line or "stack frame" in line:
            print(f"  {label} {fn[:48]}: {line.split(':', 2)[-1].strip()}")


def sass_counts(label: str, so: Path, outdir: Path) -> None:
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    (outdir / f"{label}.sass").write_text(text)
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        ins = re.findall(r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         block)
        ops = [i.split(".")[0] for i in ins]
        count = {k: sum(o == k for o in ops)
                 for k in ("LDL", "STL", "SHFL", "BAR", "LDS", "STS",
                           "LDG", "STG", "BRA")}
        print(f"  {label} SASS {name[:60]}: {len(ops)} instructions, "
              + ", ".join(f"{k} {v}" for k, v in count.items()))


def events_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def in_turns(fns: dict) -> dict:
    """Median of 3 CUDA-event times of each function, after a warm-up,
    in turns (a, b, b, a, a, b)."""
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    keys = list(fns)
    for i in range(3):
        for k in (keys if i % 2 == 0 else keys[::-1]):
            times[k].append(events_ms(fns[k]))
    return {k: statistics.median(v) for k, v in times.items()}


# -- Viterbi ------------------------------------------------------------------

def viterbi_lib(so: Path):
    """The library; the tree's signature (with the deltas' scratch) where
    it exports ``lia_viterbi_shared_bytes``, PR 9's otherwise."""
    lib = ctypes.CDLL(str(so))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    lib.tree = hasattr(lib, "lia_viterbi_shared_bytes")
    lib.lia_viterbi.argtypes = [p, p, ll, i, f] + [p] * (4 if lib.tree
                                                         else 3)
    lib.lia_viterbi.restype = i
    if hasattr(lib, "lia_probe_read"):
        lib.lia_probe_read.argtypes = [p]
        lib.lia_probe_read.restype = i
    return lib


def viterbi_call(lib, em, lt):
    n, s = em.shape
    back = torch.empty(max(n * s, 1), dtype=torch.uint8, device=em.device)
    path = torch.empty(n, dtype=torch.int64, device=em.device)
    scratch = [back.data_ptr()]
    if lib.tree:
        deltas = torch.empty(n * s + 32, device=em.device)
        scratch.insert(0, deltas.data_ptr())
    err = lib.lia_viterbi(em.data_ptr(), lt.data_ptr(), n, s, math.log(s),
                          *scratch, path.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lia_viterbi: cudaError {err}")
    return path


def patched(text: str, kind: str) -> str:
    if MARKS[0] not in text:
        for old, new in OLD_ANCHORS.items():
            if old not in text:
                raise RuntimeError(f"no probe anchor {old!r}")
            text = text.replace(old, new, 1)
    if kind == "forward":
        return text.replace(MARKS[1], "return;")
    text = text.replace("namespace {", "namespace {" + PROBE_DECL, 1)
    text = text.replace(MARKS[0], "const long long lia_c0 = clock64();")
    text = text.replace(MARKS[1], "if (threadIdx.x == 0) lia_probe_clk[0] "
                                  "= clock64() - lia_c0;")
    text = text.replace(MARKS[2], "if (threadIdx.x == 0) lia_probe_clk[1] "
                                  "= clock64() - lia_c0;")
    return text + PROBE_READ


def probe_viterbi(label: str, src: Path, tmp: Path, outdir: Path,
                  sizes, dev) -> dict:
    so = tmp / f"{label}.so"
    print_ptxas(label, build(src, so))
    sass_counts(label, so, outdir)
    libs = {"full": viterbi_lib(so)}
    text = src.read_text()
    variants = {"forward": patched(text, "forward"),
                "clock": patched(text, "clock")}
    for name, (old, new) in STEP_VARIANTS.items():
        if old in text:
            variants[name] = patched(text.replace(old, new), "clock")
    for kind, v_text in variants.items():
        v_src = tmp / f"{label}_{kind}.cu"
        v_src.write_text(v_text)
        v_so = tmp / f"{label}_{kind}.so"
        build(v_src, v_so)
        libs[kind] = viterbi_lib(v_so)
    rng = np.random.default_rng(0)
    for n in sizes:
        em = torch.from_numpy((rng.standard_normal((n, 5)) * 3)
                              .astype(np.float32)).to(dev)
        lt = torch.log(torch.from_numpy(hmm.compute_transitions(5)
                                        .astype(np.float32)) + 1e-30).to(dev)
        want = hmm.viterbi_reference(em.cpu(), lt.cpu())
        got = viterbi_call(libs["full"], em, lt)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), f"{label}: path differs"
        t = in_turns({k: (lambda lib=lib: viterbi_call(lib, em, lt))
                      for k, lib in libs.items() if k in ("full", "forward")})
        viterbi_call(libs["clock"], em, lt)
        torch.cuda.synchronize()
        clk = (ctypes.c_longlong * 2)()
        libs["clock"].lia_probe_read(clk)
        fwd, total = clk[0], clk[1]
        print(f"  {label} N={n} S=5: full {t['full']:.3f} ms, forward "
              f"alone {t['forward']:.3f} ms; clock64: forward {fwd} cycles "
              f"({fwd / max(n - 1, 1):.1f} a step), backtrace "
              f"{total - fwd} cycles ({(total - fwd) / max(n - 1, 1):.1f} a "
              f"step); {total / t['full'] / 1e6:.3f} GHz implied; "
              f"SM clock now {nvidia_smi('clocks.sm')}")
        for name in STEP_VARIANTS:
            if name in libs:
                viterbi_call(libs[name], em, lt)
                torch.cuda.synchronize()
                libs[name].lia_probe_read(clk)
                print(f"  {label} N={n} S=5 {name}: forward "
                      f"{clk[0] / max(n - 1, 1):.1f} cycles a step")
    return libs


# -- SVM ----------------------------------------------------------------------

def svm_old_call(lib, k, y, c, n_iter=500):
    n = y.shape[-1]
    out = torch.empty((1, n), dtype=torch.float32, device=k.device)
    err = lib.lia_svm_dual(k.data_ptr(), y.data_ptr(), c.data_ptr(),
                           out.data_ptr(), 1, n, n_iter,
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old lia_svm_dual: cudaError {err}")
    return out[0]


def svm_problem(n: int, dev):
    """A target against an n-1 cohort of 512-dimensional vectors with a
    16-dimensional latent structure (linear kernel, default C)."""
    rng = np.random.default_rng(0)
    basis = rng.standard_normal((16, 512)).astype(np.float32) / 4.0
    x = (rng.standard_normal((n, 16)).astype(np.float32) @ basis
         + 0.3 * rng.standard_normal((n, 512)).astype(np.float32))
    x[0] += basis[0]
    y = np.r_[1.0, -np.ones(n - 1)].astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    k = tsvm.kernel_matrix(xt, xt).contiguous()
    c = torch.full((n,), tsvm.default_c(x), device=dev)
    return k, torch.from_numpy(y).to(dev), c


SVM_PROBES = {
    "// probe: kernel begins":
        "long long lia_acc0 = 0, lia_acc1 = 0, lia_t0 = 0, lia_t1 = 0;",
    "// probe: step begins": "lia_t0 = clock64();",
    "// probe: matvec ends":
        "lia_t1 = clock64(); lia_acc0 += lia_t1 - lia_t0;",
    "// probe: projection ends": "lia_acc1 += clock64() - lia_t1;",
    "// probe: kernel ends":
        "if (threadIdx.x == 0 && blockIdx.x == 0) { lia_probe_clk[0] = "
        "lia_acc0; lia_probe_clk[1] = lia_acc1; }",
}


def svm_clock_lib(tmp: Path):
    text = _build.SOURCES["svm_dual"].read_text()
    text = text.replace("namespace {", "namespace {" + PROBE_DECL, 1)
    for mark, code in SVM_PROBES.items():
        if mark not in text:
            raise RuntimeError(f"no probe mark {mark!r}")
        text = text.replace(mark, code)
    src = tmp / "svm_clock.cu"
    src.write_text(text + PROBE_READ)
    build(src, tmp / "svm_clock.so")
    lib = ctypes.CDLL(str(tmp / "svm_clock.so"))
    _build._bind("svm_dual", lib)
    lib.lia_probe_read.argtypes = [ctypes.c_void_p]
    return lib


def svm_clock(lib, k, y, c, n_iter=500) -> tuple[float, float]:
    """SM cycles a FISTA step: (publication + matvec, projection)."""
    n = y.shape[0]
    plan = tsvm.solve_plan(n, tsvm.card_max_cluster())
    out = torch.empty((1, n), device=k.device)
    qbuf = torch.empty((1, n, plan.vec_len), device=k.device)
    err = lib.lia_svm_dual(k.data_ptr(), y.data_ptr(), c.data_ptr(),
                           out.data_ptr(), qbuf.data_ptr(), 1, n, n_iter,
                           plan.cluster, plan.threads, plan.rows, plan.tile,
                           int(plan.resident),
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"svm clock variant: cudaError {err}")
    torch.cuda.synchronize()
    clk = (ctypes.c_longlong * 2)()
    lib.lia_probe_read(clk)
    return clk[0] / n_iter, clk[1] / n_iter


LATENCY_SRC = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
// 1024 dependent instructions of one kind, unrolled 16 a loop trip
template <int KIND>
__global__ void chains(float* out, long long* cyc) {
    __shared__ int sm[64];
    __shared__ float xs[2][32];
    sm[threadIdx.x & 63] = (threadIdx.x + 1) & 31;
    float v = threadIdx.x * 1e-3f;
    int idx = threadIdx.x & 31;
    __syncthreads();
    if (KIND == 5) cg::this_cluster().sync();
    const long long t0 = clock64();
    for (int i = 0; i < 64; ++i) {
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            if (KIND == 0)
                v = __shfl_sync(0xffffffffu, v, (threadIdx.x + u) & 31);
            if (KIND == 1) v = v * 1.0001f + 0.5f;
            if (KIND == 2) v = fmaxf(-v, 0.5f + u);
            if (KIND == 3) idx = sm[idx];
            if (KIND == 4) __syncthreads();
            if (KIND == 5) cg::this_cluster().sync();
            if (KIND == 6) {                // a warp's exchange in smem
                xs[u & 1][threadIdx.x] = v;
                __syncwarp();
                v = xs[u & 1][(threadIdx.x + 1) & 31];
            }
        }
    }
    const long long t1 = clock64();
    if (threadIdx.x == 0) { cyc[blockIdx.x] = t1 - t0; out[0] = v + idx; }
}
template <int KIND>
int run(int blocks, void* out, void* cyc) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(KIND == 4 || KIND == 5 ? 128 : 32);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = blocks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaFuncSetAttribute(chains<KIND>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaError_t e = cudaLaunchKernelEx(&cfg, chains<KIND>, (float*)out,
                                       (long long*)cyc);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaDeviceSynchronize();
}
extern "C" int lia_latency(int kind, int blocks, void* out, void* cyc) {
    switch (kind) {
        case 0: return run<0>(blocks, out, cyc);
        case 1: return run<1>(blocks, out, cyc);
        case 2: return run<2>(blocks, out, cyc);
        case 3: return run<3>(blocks, out, cyc);
        case 4: return run<4>(blocks, out, cyc);
        case 5: return run<5>(blocks, out, cyc);
        default: return run<6>(blocks, out, cyc);
    }
}
"""


def probe_latencies(tmp: Path, dev) -> None:
    src = tmp / "latency.cu"
    src.write_text(LATENCY_SRC)
    build(src, tmp / "latency.so")
    lib = ctypes.CDLL(str(tmp / "latency.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lia_latency.argtypes = [i, i, p, p]
    lib.lia_latency.restype = i
    out = torch.zeros(1, device=dev)
    cyc = torch.zeros(16, dtype=torch.int64, device=dev)
    line = []
    for label, kind, blocks in (("SHFL.IDX", 0, 1), ("FFMA", 1, 1),
                                ("FMNMX", 2, 1), ("LDS", 3, 1),
                                ("__syncthreads (4 warps)", 4, 1),
                                ("cluster barrier (2 blocks)", 5, 2),
                                ("cluster barrier (16 blocks)", 5, 16),
                                ("STS + __syncwarp + LDS", 6, 1)):
        for _ in range(2):                     # the second call is warm
            err = lib.lia_latency(kind, blocks, out.data_ptr(),
                                  cyc.data_ptr())
            if err:
                raise RuntimeError(f"latency {label}: cudaError {err}")
        line.append(f"{label} {float(cyc[:blocks].max()) / 1024:.1f}")
    print("  latency, SM cycles an instruction on a dependent chain of "
          "1024 (unrolled 16 a loop trip): " + ", ".join(line))


def probe_svm(baseline: Path | None, tmp: Path, outdir: Path, sizes,
              dev) -> None:
    new_so = tmp / "svm_tree.so"
    print_ptxas("svm tree", build(_build.SOURCES["svm_dual"], new_so))
    sass_counts("svm_tree", new_so, outdir)
    clock_lib = svm_clock_lib(tmp)
    old = None
    if baseline is not None:
        old_so = tmp / "svm_baseline.so"
        print_ptxas("svm baseline", build(baseline, old_so))
        sass_counts("svm_baseline", old_so, outdir)
        old = ctypes.CDLL(str(old_so))
        p, i = ctypes.c_void_p, ctypes.c_int
        old.lia_svm_dual.argtypes = [p, p, p, p, i, i, i, p]
        old.lia_svm_dual.restype = i
    for n in sizes:
        k, y, c = svm_problem(n, dev)
        fns = {"tree": lambda: tsvm.dual_solve_cuda(k, y, c),
               "tree0": lambda: tsvm.dual_solve_cuda(k, y, c, n_iter=0)}
        if old is not None:
            fns = {"baseline": lambda: svm_old_call(old, k, y, c),
                   "baseline0": lambda: svm_old_call(old, k, y, c, 0),
                   **fns}
        t = in_turns(fns)
        mv, pj = svm_clock(clock_lib, k, y, c)
        line = [f"svm N={n}: tree {t['tree']:.3f} ms, "
                f"{1e3 * (t['tree'] - t['tree0']) / 500:.2f} us a FISTA step "
                f"(clock64, block 0: {mv:.0f} cycles publication + matvec, "
                f"{pj:.0f} projection)"]
        if old is not None:
            a_new = tsvm.dual_solve_cuda(k, y, c)
            a_old = svm_old_call(old, k, y, c)
            line.append(f"baseline {t['baseline']:.3f} ms, "
                        f"{1e3 * (t['baseline'] - t['baseline0']) / 500:.2f} "
                        f"us a FISTA step, max|alpha_tree - alpha_baseline| "
                        f"{float((a_new - a_old).abs().max()):.3e} (C "
                        f"{float(c.max()):.3e})")
        print("  " + "; ".join(line))
        del k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/probe")
    ap.add_argument("--viterbi-baseline", type=Path)
    ap.add_argument("--svm-baseline", type=Path)
    ap.add_argument("--viterbi-n", default="30000,60000")
    ap.add_argument("--svm-n", default="55,1001,4096")
    ap.add_argument("--skip-svm", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(nvidia_smi("name,power.limit"))
    dev = torch.device("cuda", 0)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    vit_n = [int(v) for v in args.viterbi_n.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if args.viterbi_baseline is not None:
            probe_viterbi("viterbi_baseline", args.viterbi_baseline, tmp,
                          outdir, vit_n, dev)
        probe_viterbi("viterbi_tree", _build.SOURCES["viterbi"], tmp, outdir,
                      vit_n, dev)
        probe_latencies(tmp, dev)
        if not args.skip_svm:
            probe_svm(args.svm_baseline, tmp, outdir,
                      [int(v) for v in args.svm_n.split(",")], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
