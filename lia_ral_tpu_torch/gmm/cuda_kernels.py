"""Wrappers of the hand-written CUDA kernels K1 and K2, and their plain
PyTorch versions (port of lia_ral_tpu/gmm/pallas_kernels.py).

K1 ``em_stats_fused``: EM sufficient stats over a weighted frame block
(replaces the Pallas ``em_stats_fused``).  K2 ``bw_stats_fused``:
per-utterance Baum-Welch (N, F) stats and weighted llk (replaces the
Pallas ``bw_stats_fused``).  The kernels live in ``csrc/gmm_stats.cu``;
its header says how they are laid out for Hopper.

Dispatch is on the device of the input, with no fallback: a CPU tensor
goes to the plain version (``em_stats_reference``/``bw_stats_reference``),
a CUDA tensor launches the kernel or raises.  Only the default,
f32-grade tier is ported; the fastStats (``stats_pass="bf16nx"``) and
fastMath (``compute_dtype=torch.bfloat16``) tiers raise
NotImplementedError on every device until they are.

``launch_counts`` counts kernel launches per wrapper (plain ints, one
per launch, nothing else adds to them), so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import torch

from .kernels import EmStats, em_stats_chunked, llk_and_posteriors
from .model import GmmDiag

MAX_DIM = 64                    # largest feature dim the kernels take

launch_counts = {"em_stats_fused": 0, "bw_stats_fused": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def check_tier(compute_dtype=None, stats_pass: str = "x3") -> None:
    """Raise for an arithmetic tier the port does not run (yet)."""
    if compute_dtype is torch.bfloat16:
        raise NotImplementedError(
            "fastMath tier (bf16 densities) is not ported to CUDA yet")
    if stats_pass == "bf16nx":
        raise NotImplementedError(
            "fastStats tier (stats_pass='bf16nx') is not ported to CUDA yet")
    if compute_dtype not in (None, torch.float32):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    if stats_pass != "x3":
        raise ValueError(f"stats_pass {stats_pass!r} is a TPU sweep mode; "
                         "only 'x3' (the default tier) exists here")


# -- plain versions -------------------------------------------------------

def em_stats_reference(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                       chunk: int = 4096) -> EmStats:
    """Plain version of K1: ``kernels.em_stats_chunked``."""
    return em_stats_chunked(x, w, gmm, chunk=chunk)


def bw_stats_reference(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                       batch: int = 64
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: per-utterance (n (S,K), f (S,K,D), weighted
    llk (S,)) of x (S,T,D), w (S,T), ``batch`` utterances at a time."""
    s, t, d = x.shape
    ns, fs, ls = [], [], []
    for b in range(0, s, batch):
        xb, wb = x[b:b + batch], w[b:b + batch]
        llk, post = llk_and_posteriors(xb.reshape(-1, d), gmm)
        pw = post.reshape(xb.shape[0], t, -1) * wb[..., None]  # (B,T,K)
        ns.append(torch.sum(pw, dim=1))
        fs.append(pw.transpose(1, 2) @ xb)
        ls.append(torch.sum(llk.reshape(xb.shape[0], t) * wb, dim=1))
    return torch.cat(ns), torch.cat(fs), torch.cat(ls)


# -- kernels --------------------------------------------------------------

def kernel_params(gmm: GmmDiag) -> torch.Tensor:
    """(2D+1, K) = [−½Σ⁻¹; μΣ⁻¹; cst]: the TPU kernel's B matrix without
    its zero row, cst = log w_k + log-normaliser − ½Σ μ²Σ⁻¹ riding the
    design's constant-1 column."""
    mi = gmm.means * gmm.cov_inv
    cst = (gmm.log_weights() + gmm.log_const()
           - 0.5 * torch.sum(gmm.means * mi, dim=-1))
    return torch.cat([-0.5 * gmm.cov_inv, mi, cst[:, None]],
                     dim=1).T.contiguous()


def _check_cuda_inputs(name: str, x: torch.Tensor, w: torch.Tensor,
                       gmm: GmmDiag) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device} have no kernel")
    for label, t in (("x", x), ("w", w), ("weights", gmm.weights),
                     ("means", gmm.means), ("cov_inv", gmm.cov_inv)):
        if t.device != x.device:
            raise ValueError(f"{name}: {label} is on {t.device}, "
                             f"x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.shape[-1] != gmm.dim:
        raise ValueError(f"{name}: x has dim {x.shape[-1]}, "
                         f"the GMM {gmm.dim}")
    if not 0 < gmm.dim <= MAX_DIM:
        raise ValueError(f"{name}: feature dim {gmm.dim} outside "
                         f"1..{MAX_DIM}")
    if w.shape != x.shape[:-1] or x.numel() == 0:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not match or are empty")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {err})")


def em_stats_fused(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                   chunk: int = 8192, compute_dtype=None,
                   stats_pass: str = "x3") -> EmStats:
    """K1: EM stats of x (N,D) with frame weights w (N,).

    On CUDA, ``chunk`` frames go to each CTA row of the stats pass; the
    per-chunk partials are added in a fixed order, so the result
    reproduces to every digit for a given N and chunk."""
    check_tier(compute_dtype, stats_pass)
    if x.device.type == "cpu":
        return em_stats_reference(x, w, gmm)
    _check_cuda_inputs("em_stats_fused", x, w, gmm)
    from .._build import library

    lib = library()
    n, d = x.shape
    k = gmm.n_components
    a = 2 * d + 2
    n_chunks = -(-n // chunk)
    params = kernel_params(gmm)
    opts = dict(dtype=torch.float32, device=x.device)
    llk = torch.empty((n,), **opts)
    partials = torch.empty((n_chunks, k + 1, a), **opts)
    out = torch.empty((k + 1, a), **opts)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.lia_em_stats(x.data_ptr(), w.data_ptr(), params.data_ptr(),
                               n, d, k, chunk, llk.data_ptr(),
                               partials.data_ptr(), out.data_ptr(), stream)
    _raise_on(err, "em_stats_fused")
    launch_counts["em_stats_fused"] += 1
    return EmStats(n=out[:k, 2 * d], sum_x=out[:k, d:2 * d],
                   sum_xx=out[:k, :d], llk=out[k, 0], count=out[k, 1])


def bw_stats_fused(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                   compute_dtype=None, stats_pass: str = "x3"
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: per-utterance stats of a padded batch x (S,T,D), weights
    w (S,T).  Returns (n (S,K), f (S,K,D), weighted llk (S,)).

    On CUDA one CTA owns one (utterance, 64-component tile) and loops
    over all T frames itself, so no sum crosses CTAs."""
    check_tier(compute_dtype, stats_pass)
    if x.device.type == "cpu":
        return bw_stats_reference(x, w, gmm)
    _check_cuda_inputs("bw_stats_fused", x, w, gmm)
    if x.dim() != 3:
        raise ValueError(f"bw_stats_fused: x must be (S,T,D), got "
                         f"{tuple(x.shape)}")
    from .._build import library

    lib = library()
    s, t, d = x.shape
    k = gmm.n_components
    params = kernel_params(gmm)
    opts = dict(dtype=torch.float32, device=x.device)
    llk = torch.empty((s * t,), **opts)
    out = torch.empty((s, k + 1, 2 * d + 2), **opts)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.lia_bw_stats(x.data_ptr(), w.data_ptr(), params.data_ptr(),
                               s, t, d, k, llk.data_ptr(), out.data_ptr(),
                               stream)
    _raise_on(err, "bw_stats_fused")
    launch_counts["bw_stats_fused"] += 1
    return out[:, :k, 2 * d], out[:, :k, d:2 * d], out[:, k, 0]
