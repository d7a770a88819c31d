"""Wrappers of the hand-written CUDA kernels K1 and K2, and their plain
PyTorch versions (port of lia_ral_tpu/gmm/pallas_kernels.py).

K1 ``em_stats_fused``: EM sufficient stats over a weighted frame block
(replaces the Pallas ``em_stats_fused``).  K2 ``bw_stats_fused``:
per-utterance Baum-Welch (N, F) stats and weighted llk (replaces the
Pallas ``bw_stats_fused``).  The kernels live in
``csrc/gmm_stats_wgmma.cu`` (both products on the tensor cores, ``wgmma``
with bf16 operands); its header says how they are laid out for Hopper
and where each arithmetic tier rounds.

Tiers, as the JAX kernels name them: the default (``bf16x3``: both
operands of each product split into bf16 hi and lo, three passes,
f32-grade), fastStats (``stats_pass="bf16nx"``: one bf16 pass for the S/F
contraction, exact occupancies), fastMath
(``compute_dtype=torch.bfloat16``: one-pass bf16 base-2 logits and a
one-pass bf16 stats product whose column 2D is the occupancy, as the TPU's
matrix unit runs an f32 product at default precision), and both
together.  All run base-2 logits.  Each tier has a plain version here
that rounds at the same points as its kernel.

Dispatch is on the device of the input, with no fallback: a CPU tensor
goes to the plain version (``em_stats_reference``/``bw_stats_reference``),
a CUDA tensor launches the kernel or raises.  That holds for the wrappers
here.  One caller chooses differently off the card:
``em.default_stats_fn``, the stats pass of the trainers, sends a CPU
tensor of the default tier to the true-f32 path
(``kernels.em_stats_chunked``) and not to ``em_stats_reference``, because
the JAX package too leaves its kernel for the f32 XLA path off the TPU
and the CPU parity tests of the trainers hold the two packages together
at f32 budgets.  The two CPU answers differ by the three-pass product's
rounding (~1e-5 of the largest sum; tests/test_torch_stats_kernels.py
``test_cpu_default_route_is_the_f32_stats_path`` holds the bound).

``launch_counts`` counts kernel launches per wrapper and tier (plain
ints, one per launch, nothing else adds to them), e.g.
``em_stats_fused[fastStats]``, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import math

import torch

from .kernels import EmStats
from .model import GmmDiag

MAX_DIM = 64                    # largest feature dim the kernels take
LOG2_E = 1.4426950408889634
LN_2 = math.log(2.0)

TIERS = ("", "fastStats", "fastMath", "fastMath+fastStats")   # by kernel id
launch_counts = {f"{k}[{t}]" if t else k: 0
                 for k in ("em_stats_fused", "bw_stats_fused") for t in TIERS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def check_tier(compute_dtype=None, stats_pass: str = "x3") -> int:
    """The kernels' tier id (0 default, 1 fastStats, 2 fastMath, 3 both);
    raises for a mode only the JAX package's sweep scripts reach."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    if stats_pass not in ("x3", "bf16nx"):
        raise ValueError(f"stats_pass {stats_pass!r} is a TPU sweep mode; "
                         "only 'x3' (default) and 'bf16nx' (fastStats) "
                         "exist here")
    return ((2 if compute_dtype is torch.bfloat16 else 0)
            + (1 if stats_pass == "bf16nx" else 0))


def _count_key(kernel: str, tier: int) -> str:
    return f"{kernel}[{TIERS[tier]}]" if tier else kernel


# -- plain versions -------------------------------------------------------

def _bf16r(t: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 and back to f32 (so a CPU matmul of two
    rounded operands multiplies exactly and accumulates in f32, as the
    tensor units do; torch's CPU bf16 @ bf16 would return bf16)."""
    return t.to(torch.bfloat16).float()


def tier_params(gmm: GmmDiag, tier: int) -> torch.Tensor:
    """The (2D+1, K) parameter matrix a tier's kernel takes.  The tiers
    run base-2 logits, as the TPU kernel does under its default
    ``exp_mode="exp2"``: B and the cst row are scaled by log2(e), and for
    fastMath the B rows are then rounded to bf16 while cst stays f32
    (lia_ral_tpu/gmm/pallas_kernels.py:289-312).  Tier 0 returns the
    natural-base matrix of ``kernel_params``; the default tier's plain
    version scales it as fastStats does (``_plain_params``)."""
    bt = kernel_params(gmm)
    if tier == 0:
        return bt
    if tier == 1:
        return bt * LOG2_E
    d = gmm.dim
    return torch.cat([_bf16r(bt[:2 * d] * LOG2_E), bt[2 * d:] * LOG2_E])


def _plain_params(gmm: GmmDiag, tier: int) -> torch.Tensor:
    """The base-2 parameter matrix of a tier's plain version: the default
    tier's is fastStats' (scaled by log2(e), not rounded: its products
    split it into bf16 hi and lo)."""
    return tier_params(gmm, tier or 1)


def _split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _bf16r(t)
    return hi, _bf16r(t - hi)


def _dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u @ v as the default tier computes it: both operands split into
    bf16 hi and lo, hi·hi + (hi·lo + lo·hi) accumulated in f32
    (lia_ral_tpu/gmm/pallas_kernels.py:152-163)."""
    uh, ul = _split(u)
    vh, vl = _split(v)
    return uh @ vh + (uh @ vl + ul @ vh)


def _tier_block(x: torch.Tensor, w: torch.Tensor, bt: torch.Tensor,
                tier: int):
    """Plain version of one tier on x (B,T,D), w (B,T): per utterance
    (n (B,K), sum_x (B,K,D), sum_xx (B,K,D), Σ w·llk (B,)), rounding where
    the TPU kernel rounds.  The logits are the base-2 xa·B with
    xa = [x², x, 1]; p = exp2(ld − m) unnormalised with m the row max,
    s = w / Σp, and the stats pᵀ·(xa·s).  Default tier: both products as
    three bf16 passes (``_dot3``).  fastMath: one-pass logits on bf16
    operands, cst added in f32, and one-pass stats on bf16 operands
    with the occupancy that product's column 2D (the TPU kernel's
    ``jnp.dot(p.T, xs, precision=DEFAULT)`` on f32 operands is one bf16
    pass on the matrix unit).  fastStats: one-pass stats on bf16
    operands, the occupancy column the exact Σ p·s instead."""
    d = x.shape[-1]
    xa = torch.cat([x * x, x, torch.ones_like(x[..., :1])], dim=-1)
    if tier >= 2:           # fastMath: bf16 operands, cst added in f32
        ld = _bf16r(xa[..., :2 * d]) @ bt[:2 * d] + bt[2 * d]
    else:
        ld = _dot3(xa, bt)
    m = torch.amax(ld, dim=-1, keepdim=True)
    p = torch.exp2(ld - m)
    ssum = torch.sum(p, dim=-1)
    llk = torch.log(ssum) + m[..., 0] * LN_2
    s = w / ssum
    xs = xa * s[..., None]
    if tier:                # one bf16 pass
        stats = _bf16r(p).transpose(-1, -2) @ _bf16r(xs)
    else:
        stats = _dot3(p.transpose(-1, -2), xs)
    if tier & 1:            # fastStats: the exact occupancy
        n = torch.sum(p * s[..., None], dim=-2)
    else:
        n = stats[..., 2 * d]
    return (n, stats[..., d:2 * d], stats[..., :d],
            torch.sum(llk * w, dim=-1))


def em_stats_reference(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                       chunk: int = 4096, compute_dtype=None,
                       stats_pass: str = "x3") -> EmStats:
    """Plain version of K1 in the given tier, ``chunk`` frames at a
    time."""
    tier = check_tier(compute_dtype, stats_pass)
    bt = _plain_params(gmm, tier)
    acc = EmStats.zeros(gmm.n_components, gmm.dim, x.dtype, x.device)
    for s0 in range(0, x.shape[0], chunk):
        xc, wc = x[s0:s0 + chunk], w[s0:s0 + chunk]
        n, sx, sxx, ll = _tier_block(xc[None], wc[None], bt, tier)
        acc = acc.merge(EmStats(n=n[0], sum_x=sx[0], sum_xx=sxx[0],
                                llk=ll[0], count=torch.sum(wc)))
    return acc


def bw_stats_reference(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                       batch: int = 64, compute_dtype=None,
                       stats_pass: str = "x3"
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: per-utterance (n (S,K), f (S,K,D), weighted
    llk (S,)) of x (S,T,D), w (S,T), ``batch`` utterances at a time."""
    tier = check_tier(compute_dtype, stats_pass)
    bt = _plain_params(gmm, tier)
    ns, fs, ls = [], [], []
    for b in range(0, x.shape[0], batch):
        n, f, _, ll = _tier_block(x[b:b + batch], w[b:b + batch], bt, tier)
        ns.append(n)
        fs.append(f)
        ls.append(ll)
    return torch.cat(ns), torch.cat(fs), torch.cat(ls)


# -- kernels --------------------------------------------------------------

def kernel_params(gmm: GmmDiag) -> torch.Tensor:
    """(2D+1, K) = [−½Σ⁻¹; μΣ⁻¹; cst]: the TPU kernel's B matrix without
    its zero row, cst = log w_k + log-normaliser − ½Σ μ²Σ⁻¹ riding the
    design's constant-1 column.  The plain versions take it (through
    ``tier_params``); on the card a prep kernel writes the same matrix,
    split into bf16 hi and lo, straight from the GMM."""
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


N_SM = 132                      # streaming multiprocessors of an H100
STATS_K_BLOCK = 128             # components per CTA of the stats pass
FRAME_TILE = 128                # frames per tile of the stats pass
MAX_CHUNK = 8192


def stats_chunk_len(n: int, k: int) -> int:
    """Frames per row of K1's stats grid (chunks × K blocks): a pure
    function of N and K.  Small N is cut so that the grid has about two
    CTAs per SM where N allows; large N takes ``MAX_CHUNK`` frames, which
    keeps the last wave short.  A multiple of the frame tile.  The
    per-chunk partials are added in chunk order, so the result is a
    function of the inputs alone."""
    k_blocks = -(-k // STATS_K_BLOCK)
    want = -(-2 * N_SM // k_blocks)
    per = -(-n // want)
    return min(MAX_CHUNK, max(FRAME_TILE, -(-per // FRAME_TILE) * FRAME_TILE))


def _launch(name: str, tier: int, x: torch.Tensor, call) -> None:
    with torch.cuda.device(x.device):
        err = call(torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, name)
    launch_counts[_count_key(name, tier)] += 1


def em_stats_fused(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                   chunk: int | None = None, compute_dtype=None,
                   stats_pass: str = "x3") -> EmStats:
    """K1: EM stats of x (N,D) with frame weights w (N,).

    On CUDA, ``chunk`` frames (default: ``stats_chunk_len(N, K)``) go to
    each CTA row of the stats pass; the per-chunk partials are added in a
    fixed order (a single chunk writes the result directly), so the result
    reproduces to every digit for a given N and chunk."""
    tier = check_tier(compute_dtype, stats_pass)
    if x.device.type == "cpu":
        return em_stats_reference(x, w, gmm, compute_dtype=compute_dtype,
                                  stats_pass=stats_pass)
    _check_cuda_inputs("em_stats_fused", x, w, gmm)
    from .._build import library

    lib = library()
    n, d = x.shape
    k = gmm.n_components
    if chunk is None:
        chunk = stats_chunk_len(n, k)
    n_chunks = -(-n // chunk)
    scratch = torch.empty(
        (lib.lia_stats_scratch_bytes(n, d, k, chunk, n_chunks, n_chunks > 1),),
        dtype=torch.uint8, device=x.device)
    out = torch.empty((k + 1, 2 * d + 2), dtype=torch.float32,
                      device=x.device)
    _launch("em_stats_fused", tier, x, lambda stream: lib.lia_em_stats_wgmma(
        x.data_ptr(), w.data_ptr(), gmm.weights.data_ptr(),
        gmm.means.data_ptr(), gmm.cov_inv.data_ptr(), n, d, k, chunk, tier,
        scratch.data_ptr(), out.data_ptr(), stream))
    return EmStats(n=out[:k, 2 * d], sum_x=out[:k, d:2 * d],
                   sum_xx=out[:k, :d], llk=out[k, 0], count=out[k, 1])


def bw_stats_fused(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                   compute_dtype=None, stats_pass: str = "x3"
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: per-utterance stats of a padded batch x (S,T,D), weights
    w (S,T).  Returns (n (S,K), f (S,K,D), weighted llk (S,)).

    On CUDA one CTA owns one (utterance, 128-component block) and loops
    over all T frames itself, so no sum crosses CTAs."""
    tier = check_tier(compute_dtype, stats_pass)
    if x.device.type == "cpu":
        return bw_stats_reference(x, w, gmm, compute_dtype=compute_dtype,
                                  stats_pass=stats_pass)
    _check_cuda_inputs("bw_stats_fused", x, w, gmm)
    if x.dim() != 3:
        raise ValueError(f"bw_stats_fused: x must be (S,T,D), got "
                         f"{tuple(x.shape)}")
    from .._build import library

    lib = library()
    s, t, d = x.shape
    k = gmm.n_components
    scratch = torch.empty((lib.lia_stats_scratch_bytes(s * t, d, k, t, s, 0),),
                          dtype=torch.uint8, device=x.device)
    out = torch.empty((s, k + 1, 2 * d + 2), dtype=torch.float32,
                      device=x.device)
    _launch("bw_stats_fused", tier, x, lambda stream: lib.lia_bw_stats_wgmma(
        x.data_ptr(), w.data_ptr(), gmm.weights.data_ptr(),
        gmm.means.data_ptr(), gmm.cov_inv.data_ptr(), s, t, d, k, tier,
        scratch.data_ptr(), out.data_ptr(), stream))
    return out[:, :k, 2 * d], out[:, :k, d:2 * d], out[:, k, 0]
