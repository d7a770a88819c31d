"""Wrappers of the hand-written CUDA kernels K1 and K2, and their plain
PyTorch versions (port of lia_ral_tpu/gmm/pallas_kernels.py).

K1 ``em_stats_fused``: EM sufficient stats over a weighted frame block
(replaces the Pallas ``em_stats_fused``).  K2 ``bw_stats_fused``:
per-utterance Baum-Welch (N, F) stats and weighted llk (replaces the
Pallas ``bw_stats_fused``).  The kernels live in
``csrc/gmm_stats_wgmma.cu`` (both products on the tensor cores, ``wgmma``
with bf16 operands); its header says how they are laid out for Hopper.

The arithmetic is chosen as the JAX kernels choose it, by
``compute_dtype``, ``mxu_precision``, ``exp_mode`` and ``stats_pass``
(``check_mode`` turns them into a ``Mode``), in every combination the JAX
wrappers take.  Line numbers are those of pallas_kernels.py.

Logits ld = xa·B with xa = [x², x, 1] and B = [−½Σ⁻¹; μΣ⁻¹; cst]:
  - ``mxu_precision="bf16x3"`` (default) or ``"high"``: three bf16 passes
    (:152-163, :168-172, :302-304).  Each operand v is split into
    hi = bf16(v), lo = bf16(v − hi); the product is hi·hi + hi·lo + lo·hi
    in f32, and cst rides the constant-1 row of B (:307-312).
  - ``"highest"``: six bf16 passes, as XLA runs Precision.HIGHEST on the
    TPU's matrix unit (:173-176, :306).  Each operand is split into three
    pieces hi = bf16(v), mid = bf16(v − hi), lo = bf16(v − hi − mid); the
    product is hi·hi + hi·mid + mid·hi + hi·lo + mid·mid + lo·hi in f32, and
    cst is added in f32 after it.
  - ``"default"``, or ``compute_dtype=torch.bfloat16`` whatever
    ``mxu_precision`` says (:300-301): one pass on bf16(xa) and bf16(B),
    cst added in f32 after it (:174-176, :294-295).  That is fastMath, bit
    for bit, whichever of the two names asks for it.
  - ``"default"`` and ``"highest"`` are read in any case, as JAX's
    ``getattr(Precision, mxu_precision.upper())`` reads them.  Any other
    name raises ``ValueError`` (JAX raises ``AttributeError`` from that
    ``getattr``); so does ``"HIGH"`` spelt other than ``"high"``, which JAX
    hands to Mosaic as Precision.HIGH and Mosaic does not lower (:303).
Exponentials (``exp_mode``, :110-133):
  - ``"exp2"`` (default): B and cst scaled by log2(e) before any rounding
    (:289-293), p = 2^(ld − m), llk = ln Σp + m·ln 2.
  - ``"exp"``: B and cst unscaled (one-pass logits round the unscaled B),
    p = exp(ld − m), llk = ln Σp + m.
  - ``"fast2"``: base 2 as ``"exp2"``, p from ``_fast_exp2`` (:48-62): the
    clamp at −120, floor, a degree-4 polynomial of the fraction evaluated
    one rounded operation at a time, and the integer part shifted into the
    exponent field.
Stats S = pᵀ·(xa·s), s = w / Σp, with n its column 2D
(``stats_pass``, :75-107, :179-206):
  - ``"x3"`` (default): the logits' passes: three (hi/lo splits of p and
    xa·s), six (hi/mid/lo splits), or one (bf16(p)·bf16(xa·s)).
  - ``"bf16"``: one pass on bf16(p) and bf16(xa·s) (:89-90).
  - ``"bf16nx"`` (fastStats): that pass, with the occupancy column the
    exact f32 Σ p·s instead (:91-97).
  - ``"bf16x2p"``: hi(p)·bf16(xa·s) + lo(p)·bf16(xa·s) (:99-102).
  - ``"bf16x2x"``: bf16(p)·hi(xa·s) + bf16(p)·lo(xa·s) (:103-106).
  - ``"bf16sr"``: p and xa·s each rounded to bf16 stochastically, then one
    pass (:188-198).  The TPU draws the bits from its hardware PRNG, which
    nothing reproduces; here a counter-based generator (``sr_bits``:
    Philox4x32-10, keyed on ``seed``, the operand, the global frame index
    and the column) gives them, so the result depends neither on
    ``chunk`` nor on the grid.  One counter gives p's bits for two frames
    and two components eight apart (the four elements a thread of the
    kernel holds), or xa·s's for four design columns of a frame.  The
    rounding adds the 16 low random bits to the f32 bit pattern and
    truncates to bf16, as ``pltpu.stochastic_round`` does.
  - Any other name raises ``ValueError``.
The JAX kernels read an unknown ``exp_mode`` as ``"fast2"`` and an unknown
``stats_pass`` as ``"x3"`` (their ``else`` branches), and ignore
``mxu_precision`` under ``compute_dtype=bfloat16``; the port raises for an
unknown name in every case, and for a ``compute_dtype`` other than None,
float32 or bfloat16.  The TPU's ``block`` (its tiling) and ``interpret``
(its debugging mode) have no counterpart: K1's ``chunk`` is the card's
tiling knob.  Each arithmetic has a plain version here that rounds at the
same points as its kernel.

The four tiers that config keys reach are four of these modes: the
default (three-pass logits and stats), fastStats (``stats_pass="bf16nx"``),
fastMath (``compute_dtype=torch.bfloat16``) and both together.

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

``launch_counts`` counts kernel launches per wrapper and arithmetic
(plain ints, one per launch, nothing else adds to them), keyed
``em_stats_fused[<Mode.name>]``, e.g. ``em_stats_fused[fastStats]`` or
``bw_stats_fused[exp_mode=fast2,stats_pass=bf16]``, and
``em_stats_fused_grouped`` for K1's grouped entry, so a run can show
that its main path went through the kernels.  A spelling that runs an
existing arithmetic counts under it: ``mxu_precision="high"`` under the
default, ``"default"`` under fastMath.  While a profiler records, the
CUDA path of each wrapper opens the span ``lia.gmm.<wrapper>`` around
its scratch allocation and launch (``utils.logging.span``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading

import numpy as np
import torch

from ..utils.logging import span
from .kernels import EmStats
from .model import GmmDiag

MAX_DIM = 64                    # largest feature dim the kernels take
LOG2_E = 1.4426950408889634
LN_2 = math.log(2.0)
# _fast_exp2's polynomial for 2^f on [0, 1), highest power first
# (lia_ral_tpu/gmm/pallas_kernels.py:59-60)
FAST_EXP2_COEFFS = (0.0135115532, 0.0519895369, 0.2415088773, 0.6929742561,
                    1.0000052588)

EXP_MODES = ("exp2", "exp", "fast2")                    # the kernel's ids
STATS_PASSES = ("x3", "bf16", "bf16nx", "bf16x2p", "bf16x2x", "bf16sr")
# the stats product's forms (the kernel's ids): one pass, p split, xa·s
# split, three passes, six passes, stochastic rounding
STATS_FORMS = ("1", "2p", "2x", "3", "6", "sr")
_FORM_OF_PASS = {"bf16": "1", "bf16nx": "1", "bf16x2p": "2p",
                 "bf16x2x": "2x", "bf16sr": "sr"}
_FOLLOWS = {1: "1", 3: "3", 6: "6"}     # "x3": the logits' own passes


@dataclasses.dataclass(frozen=True)
class Mode:
    """One arithmetic of K1/K2: the logit product's bf16 passes (1, 3 or
    6), the exponential (``EXP_MODES``), the stats product's form
    (``STATS_FORMS``) and whether the occupancy is the exact Σ p·s."""

    logit_passes: int
    exp_mode: str
    stats: str
    nx: bool = False

    @property
    def stat_passes(self) -> int:
        return {"1": 1, "2p": 2, "2x": 2, "3": 3, "6": 6, "sr": 1}[self.stats]

    @property
    def stats_pass(self) -> str:
        """The JAX ``stats_pass`` that gives this stats form."""
        if self.nx:
            return "bf16nx"
        if self.stats == _FOLLOWS[self.logit_passes]:
            return "x3"
        return {"1": "bf16", "2p": "bf16x2p", "2x": "bf16x2x",
                "sr": "bf16sr"}[self.stats]

    @property
    def name(self) -> str:
        """The launch-count key's suffix: a tier's name, then the settings
        that differ from it, e.g. ``fastStats,exp_mode=fast2``."""
        tier = ("fastMath" if self.logit_passes == 1 else "") + (
            "+fastStats" if self.nx else "")
        parts = [tier.lstrip("+")] if tier else []
        if self.logit_passes == 6:
            parts.append("mxu_precision=highest")
        if self.exp_mode != "exp2":
            parts.append(f"exp_mode={self.exp_mode}")
        if self.stats_pass not in ("x3", "bf16nx"):
            parts.append(f"stats_pass={self.stats_pass}")
        return ",".join(parts)

    def kwargs(self) -> dict:
        """The wrappers' keyword arguments that give this mode."""
        return dict(mxu_precision={1: "default", 3: "bf16x3",
                                   6: "highest"}[self.logit_passes],
                    exp_mode=self.exp_mode, stats_pass=self.stats_pass)

    def kernel_args(self) -> tuple[int, int, int, int]:
        """(logit passes, exp id, stats form id, nx) as the C entry points
        take them."""
        return (self.logit_passes, EXP_MODES.index(self.exp_mode),
                STATS_FORMS.index(self.stats), int(self.nx))


# the tiers by kernel id (0 default, 1 fastStats, 2 fastMath, 3 both)
TIER_MODES = (Mode(3, "exp2", "3"), Mode(3, "exp2", "1", True),
              Mode(1, "exp2", "1"), Mode(1, "exp2", "1", True))
TIERS = tuple(m.name for m in TIER_MODES)


def all_modes() -> list[Mode]:
    """Every distinct arithmetic the JAX wrappers accept, the four tiers
    first."""
    modes = list(TIER_MODES)
    for prec, em, sp in itertools.product(("bf16x3", "default", "highest"),
                                          EXP_MODES, STATS_PASSES):
        m = check_mode(None, prec, em, sp)
        if m not in modes:
            modes.append(m)
    return modes


def _count_key(kernel: str, mode: Mode) -> str:
    return f"{kernel}[{mode.name}]" if mode.name else kernel


def check_mode(compute_dtype=None, mxu_precision: str = "bf16x3",
               exp_mode: str = "exp2", stats_pass: str = "x3") -> Mode:
    """The ``Mode`` of the JAX kernels' arguments (the module docstring
    says what each name computes); raises ``ValueError`` for a name the
    port does not take."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}: None, "
                         "torch.float32 or torch.bfloat16")
    name = mxu_precision.lower() if isinstance(mxu_precision, str) else None
    if mxu_precision in ("bf16x3", "high"):
        passes = 3
    elif name in ("default", "highest"):
        passes = 1 if name == "default" else 6
    else:
        raise ValueError(
            f"mxu_precision {mxu_precision!r}: 'bf16x3' or 'high' (three "
            "bf16 passes), 'highest' (six), 'default' (one)")
    if compute_dtype is torch.bfloat16:
        passes = 1
    if exp_mode not in EXP_MODES:
        raise ValueError(f"exp_mode {exp_mode!r}: 'exp2' (base 2), 'exp' "
                         "(natural base) or 'fast2' (the bit-trick exp2)")
    if stats_pass not in STATS_PASSES:
        raise ValueError(
            f"stats_pass {stats_pass!r}: 'x3' (the logits' passes), 'bf16', "
            "'bf16nx' (exact occupancy), 'bf16x2p' (p split), 'bf16x2x' "
            "(xa·s split) or 'bf16sr' (stochastic rounding)")
    form = _FOLLOWS[passes] if stats_pass == "x3" else _FORM_OF_PASS[stats_pass]
    return Mode(passes, exp_mode, form, stats_pass == "bf16nx")


def check_tier(compute_dtype=None, stats_pass: str = "x3") -> int:
    """The tier id (0 default, 1 fastStats, 2 fastMath, 3 both) of a
    config key's arguments; raises ``ValueError`` for anything else."""
    mode = check_mode(compute_dtype, stats_pass=stats_pass)
    if mode not in TIER_MODES:
        raise ValueError(f"stats_pass {stats_pass!r} is not a tier: 'x3' "
                         "(default) or 'bf16nx' (fastStats)")
    return TIER_MODES.index(mode)


def _library(mode: Mode):
    """The kernel library of a mode: the tiers' own build, or the one that
    holds every mode (``_build.SOURCES``); built on first use."""
    from .._build import library

    return library("gmm_stats" if mode in TIER_MODES else "gmm_stats_modes")


launch_counts = {_count_key(k, m): 0 for k in ("em_stats_fused",
                                               "bw_stats_fused")
                 for m in all_modes()}
launch_counts["em_stats_fused_grouped"] = 0     # K1's grouped entry
_count_lock = threading.Lock()      # the shards of a mesh launch in threads


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# -- plain versions -------------------------------------------------------

def _bf16r(t: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 and back to f32 (so a CPU matmul of two
    rounded operands multiplies exactly and accumulates in f32, as the
    tensor units do; torch's CPU bf16 @ bf16 would return bf16)."""
    return t.to(torch.bfloat16).float()


def mode_params(gmm: GmmDiag, mode: Mode) -> torch.Tensor:
    """The (2D+1, K) parameter matrix of a mode's plain version: B and
    the cst row scaled by log2(e) in the base-2 modes, then for one-pass
    logits the B rows rounded to bf16 while cst stays f32
    (lia_ral_tpu/gmm/pallas_kernels.py:289-295)."""
    bt = kernel_params(gmm)
    if mode.exp_mode != "exp":
        bt = bt * LOG2_E
    if mode.logit_passes == 1:
        d = gmm.dim
        bt = torch.cat([_bf16r(bt[:2 * d]), bt[2 * d:]])
    return bt


# The tier-id spellings that tests/test_torch_stats_kernels.py calls
# (tier_params, _plain_params, an int mode of _tier_block); new code takes
# a Mode.
def tier_params(gmm: GmmDiag, tier: int) -> torch.Tensor:
    """Tier 0: the natural-base ``kernel_params``; the others their
    ``mode_params``."""
    return (kernel_params(gmm) if tier == 0
            else mode_params(gmm, TIER_MODES[tier]))


def _plain_params(gmm: GmmDiag, tier: int) -> torch.Tensor:
    return mode_params(gmm, TIER_MODES[tier])


def _split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _bf16r(t)
    return hi, _bf16r(t - hi)


def _split3(t: torch.Tensor):
    hi = _bf16r(t)
    r = t - hi
    mid = _bf16r(r)
    return hi, mid, _bf16r(r - mid)


def _dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u @ v as the default tier computes it: both operands split into
    bf16 hi and lo, hi·hi + (hi·lo + lo·hi) accumulated in f32
    (lia_ral_tpu/gmm/pallas_kernels.py:152-163)."""
    uh, ul = _split(u)
    vh, vl = _split(v)
    return uh @ vh + (uh @ vl + ul @ vh)


def _dot6(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u @ v at Precision.HIGHEST as the TPU's matrix unit runs it: three
    bf16 pieces each, hi·hi + hi·mid + mid·hi + hi·lo + mid·mid + lo·hi
    in f32, in the kernel's order."""
    u1, u2, u3 = _split3(u)
    v1, v2, v3 = _split3(v)
    return u1 @ v1 + u1 @ v2 + u2 @ v1 + u1 @ v3 + u2 @ v2 + u3 @ v1


def _fast_exp2(v: torch.Tensor) -> torch.Tensor:
    """``_fast_exp2`` of lia_ral_tpu/gmm/pallas_kernels.py:48-62, one
    f32-rounded operation at a time (the kernel's order)."""
    v = torch.clamp(v, min=-120.0)
    i = torch.floor(v)
    f = v - i
    c4, c3, c2, c1, c0 = FAST_EXP2_COEFFS
    p = (((c4 * f + c3) * f + c2) * f + c1) * f + c0
    return p * ((i.to(torch.int32) + 127) << 23).view(torch.float32)


# Philox4x32-10 (Salmon et al., SC'11), in int64 with 32-bit masking
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a·b for a constant a < 2^32 and b in
    [0, 2^32), by 16-bit halves so that no int64 product overflows."""
    p0 = (b & 0xFFFF) * a
    p1 = (b >> 16) * a
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (t >> 32), t & _M32


def philox4x32(ctr, key):
    """Philox4x32-10 of counters ``ctr`` (four int64 tensors of 32-bit
    words) under ``key`` (two ints): four int64 tensors of words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _M32, key[1] & _M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


SR_OPERAND_P, SR_OPERAND_XS = 0, 1


def sr_bits(seed: int, operand: int, frames: torch.Tensor,
            n_cols: int) -> torch.Tensor:
    """The 16 random bits of ``"bf16sr"`` for each (frame, column): the low
    16 bits of a word of Philox4x32-10 under the key (seed mod 2^32, seed
    div 2^32).  ``SR_OPERAND_P`` (columns are components): the counter
    (frame div 2 as two words, column with bit 3 cleared, 0), word
    (frame mod 2) + 2 (bit 3 of the column), so one counter serves frames
    2i, 2i+1 of components c, c+8, the four elements a thread of the
    kernel holds.  ``SR_OPERAND_XS`` (design columns): the counter (frame
    as two words, column div 4, 1), word column mod 4.  Each counter is
    drawn once.  frames: int64 global frame indices, any shape; returns
    int64 of shape frames.shape + (n_cols,)."""
    dev = frames.device
    ff = frames.reshape(-1).to(torch.int64)
    cols = torch.arange(n_cols, dtype=torch.int64, device=dev)
    if operand == SR_OPERAND_P:
        rows, r_inv = torch.unique(ff >> 1, return_inverse=True)
        r_word = ff & 1
        ctr_cols, c_inv = torch.unique(cols & ~8, return_inverse=True)
        c_word = ((cols >> 3) & 1) << 1
    else:
        rows, r_inv = torch.unique(ff, return_inverse=True)
        r_word = torch.zeros_like(ff)
        ctr_cols, c_inv = torch.unique(cols >> 2, return_inverse=True)
        c_word = cols & 3
    n_ctr = ctr_cols.numel()
    words = torch.empty((rows.numel() * n_ctr, 4), dtype=torch.int64,
                        device=dev)
    step = 1 << 20                  # bounds the temporaries on large calls
    for a in range(0, words.shape[0], step):
        e = torch.arange(a, min(a + step, words.shape[0]), dtype=torch.int64,
                         device=dev)
        ra, ca = rows[e // n_ctr], ctr_cols[e % n_ctr]
        words[a:a + step] = torch.stack(philox4x32(
            (ra & _M32, ra >> 32, ca, torch.full_like(ca, operand)),
            (seed & _M32, (seed >> 32) & _M32)), dim=-1) & 0xFFFF
    idx = ((r_inv[:, None] * n_ctr + c_inv[None, :]) * 4 + r_word[:, None]
           + c_word[None, :])
    return words.view(-1)[idx].view(*frames.shape, n_cols)


def _sr_round(v: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding to bf16 (returned as f32): the random bits
    added to the f32 bit pattern, the low 16 bits cut off."""
    u = (v.view(torch.int32).to(torch.int64) & _M32) + bits
    u = (u & 0xFFFF0000) & _M32
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(
        torch.int32).view(torch.float32)


def _posteriors(x: torch.Tensor, w: torch.Tensor, bt: torch.Tensor,
                mode: Mode):
    """The operands of a mode's stats product on x (B,T,D), w (B,T):
    p (B,T,K) = e(ld − m) unnormalised (ld = xa·B with xa = [x², x, 1],
    m the row max, e the mode's exponential), xs (B,T,2D+1) = xa·s with
    s = w / Σp, and the per-frame llk (B,T).  ``bt`` is ``mode_params``."""
    d = x.shape[-1]
    xa = torch.cat([x * x, x, torch.ones_like(x[..., :1])], dim=-1)
    if mode.logit_passes == 3:          # cst folded into the 1-column row
        ld = _dot3(xa, bt)
    elif mode.logit_passes == 6:        # cst added in f32 after the product
        ld = _dot6(xa[..., :2 * d], bt[:2 * d]) + bt[2 * d]
    else:                               # one pass on bf16 operands
        ld = _bf16r(xa[..., :2 * d]) @ bt[:2 * d] + bt[2 * d]
    m = torch.amax(ld, dim=-1, keepdim=True)
    if mode.exp_mode == "exp":
        p = torch.exp(ld - m)
        m_nat = m[..., 0]
    else:
        p = torch.exp2(ld - m) if mode.exp_mode == "exp2" else _fast_exp2(
            ld - m)
        m_nat = m[..., 0] * LN_2
    ssum = torch.sum(p, dim=-1)
    s = w / ssum
    return p, xa * s[..., None], torch.log(ssum) + m_nat


def _tier_block(x: torch.Tensor, w: torch.Tensor, bt: torch.Tensor,
                mode: Mode | int, frame0: int = 0, seed: int = 0):
    """Plain version of one mode (an int: a tier id) on x (B,T,D), w (B,T):
    per utterance (n (B,K), sum_x (B,K,D), sum_xx (B,K,D), Σ w·llk (B,)),
    rounding where the TPU kernel rounds (the module docstring lists the
    modes): the stats pᵀ·(xa·s) of ``_posteriors``' operands.  For
    ``"bf16sr"`` the frame of x[b, t] is frame0 + b·T + t and ``seed``
    keys the random bits (``sr_bits``)."""
    if isinstance(mode, int):
        mode = TIER_MODES[mode]
    d = x.shape[-1]
    p, xs, llk = _posteriors(x, w, bt, mode)
    pt = p.transpose(-1, -2)
    if mode.stats == "3":
        stats = _dot3(pt, xs)
    elif mode.stats == "6":
        stats = _dot6(pt, xs)
    elif mode.stats == "2p":
        ph, pl = _split(pt)
        xb = _bf16r(xs)
        stats = ph @ xb + pl @ xb
    elif mode.stats == "2x":
        pb = _bf16r(pt)
        xh, xl = _split(xs)
        stats = pb @ xh + pb @ xl
    elif mode.stats == "sr":
        b, t = x.shape[:2]
        frames = frame0 + torch.arange(b * t, device=x.device).view(b, t)
        pr = _sr_round(p, sr_bits(seed, SR_OPERAND_P, frames, p.shape[-1]))
        xr = _sr_round(xs, sr_bits(seed, SR_OPERAND_XS, frames,
                                   xs.shape[-1]))
        stats = pr.transpose(-1, -2) @ xr
    else:                               # one bf16 pass
        stats = _bf16r(pt) @ _bf16r(xs)
    if mode.nx:             # fastStats: the exact occupancy (xs[2D] = s)
        n = torch.sum(p * xs[..., 2 * d, None], dim=-2)
    else:
        n = stats[..., 2 * d]
    return (n, stats[..., d:2 * d], stats[..., :d],
            torch.sum(llk * w, dim=-1))


def em_stats_reference(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                       chunk: int = 4096, compute_dtype=None,
                       mxu_precision: str = "bf16x3", exp_mode: str = "exp2",
                       stats_pass: str = "x3", seed: int = 0) -> EmStats:
    """Plain version of K1 in the given mode, ``chunk`` frames at a
    time."""
    mode = check_mode(compute_dtype, mxu_precision, exp_mode, stats_pass)
    bt = mode_params(gmm, mode)
    acc = EmStats.zeros(gmm.n_components, gmm.dim, x.dtype, x.device)
    for s0 in range(0, x.shape[0], chunk):
        xc, wc = x[s0:s0 + chunk], w[s0:s0 + chunk]
        n, sx, sxx, ll = _tier_block(xc[None], wc[None], bt, mode, s0, seed)
        acc = acc.merge(EmStats(n=n[0], sum_x=sx[0], sum_xx=sxx[0],
                                llk=ll[0], count=torch.sum(wc)))
    return acc


def bw_stats_reference(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                       batch: int = 64, compute_dtype=None,
                       mxu_precision: str = "bf16x3", exp_mode: str = "exp2",
                       stats_pass: str = "x3", seed: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: per-utterance (n (S,K), f (S,K,D), weighted
    llk (S,)) of x (S,T,D), w (S,T), ``batch`` utterances at a time."""
    mode = check_mode(compute_dtype, mxu_precision, exp_mode, stats_pass)
    bt = mode_params(gmm, mode)
    ns, fs, ls = [], [], []
    for b in range(0, x.shape[0], batch):
        n, f, _, ll = _tier_block(x[b:b + batch], w[b:b + batch], bt, mode,
                                  b * x.shape[1], seed)
        ns.append(n)
        fs.append(f)
        ls.append(ll)
    return torch.cat(ns), torch.cat(fs), torch.cat(ls)


# -- kernels --------------------------------------------------------------

def kernel_params(gmm: GmmDiag) -> torch.Tensor:
    """(2D+1, K) = [−½Σ⁻¹; μΣ⁻¹; cst]: the TPU kernel's B matrix without
    its zero row, cst = log w_k + log-normaliser − ½Σ μ²Σ⁻¹ riding the
    design's constant-1 column.  The plain versions take it (through
    ``mode_params``); on the card a prep kernel writes the same matrix,
    split into bf16 pieces, straight from the GMM."""
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


def _launch(name: str, key: str, x: torch.Tensor, call) -> None:
    """``call(stream)`` on x's device and stream; counted under ``key``."""
    with torch.cuda.device(x.device):
        err = call(torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, name)
    with _count_lock:
        launch_counts[key] += 1


def _seed64(seed: int) -> int:
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} outside 0..2^64-1")
    return seed


def em_stats_fused(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                   chunk: int | None = None, compute_dtype=None,
                   mxu_precision: str = "bf16x3", exp_mode: str = "exp2",
                   stats_pass: str = "x3", seed: int = 0,
                   groups: Groups | None = None) -> EmStats:
    """K1: EM stats of x (N,D) with frame weights w (N,), in the mode the
    JAX arguments name (``seed`` keys ``"bf16sr"``'s random bits).

    On CUDA, ``chunk`` frames (default: ``stats_chunk_len(N, K)``) go to
    each CTA row of the stats pass; the per-chunk partials are added in a
    fixed order (a single chunk writes the result directly), so the result
    reproduces to every digit for a given N and chunk.

    With ``groups`` (``group_rows``), ``gmm`` is a bank of S models
    (weights (S,K), means and cov_inv (S,K,D)) and x, w hold each row's
    frames where ``groups`` says: the stats of each row under its own
    model, with a leading row axis, by K1's grouped entry (one launch of
    each pass); the default tier only."""
    mode = check_mode(compute_dtype, mxu_precision, exp_mode, stats_pass)
    seed = _seed64(seed)
    if groups is not None:
        if mode != TIER_MODES[0] or chunk is not None:
            raise ValueError("em_stats_fused: groups take the default tier "
                             "and their own chunks, not "
                             f"{mode.name or 'the default'} with chunk "
                             f"{chunk}")
        return _em_stats_grouped(x, w, gmm, groups)
    if x.device.type == "cpu":
        return em_stats_reference(x, w, gmm, compute_dtype=compute_dtype,
                                  mxu_precision=mxu_precision,
                                  exp_mode=exp_mode, stats_pass=stats_pass,
                                  seed=seed)
    _check_cuda_inputs("em_stats_fused", x, w, gmm)
    lib = _library(mode)
    n, d = x.shape
    k = gmm.n_components
    if chunk is None:
        chunk = stats_chunk_len(n, k)
    n_chunks = -(-n // chunk)
    lp, em, form, nx = mode.kernel_args()
    with span("lia.gmm.em_stats_fused"):
        scratch = torch.empty(
            (lib.lia_stats_scratch_bytes(n, d, k, chunk, n_chunks,
                                         n_chunks > 1, lp, form),),
            dtype=torch.uint8, device=x.device)
        out = torch.empty((k + 1, 2 * d + 2), dtype=torch.float32,
                          device=x.device)
        _launch("em_stats_fused", _count_key("em_stats_fused", mode), x,
                lambda stream: lib.lia_em_stats_wgmma(
                    x.data_ptr(), w.data_ptr(), gmm.weights.data_ptr(),
                    gmm.means.data_ptr(), gmm.cov_inv.data_ptr(), n, d, k,
                    chunk, lp, em, form, nx, seed, scratch.data_ptr(),
                    out.data_ptr(), stream))
    return EmStats(n=out[:k, 2 * d], sum_x=out[:k, d:2 * d],
                   sum_xx=out[:k, :d], llk=out[k, 0], count=out[k, 1])


GROUP_UNIT = 256        # a grouped row's first frame: a multiple of this


@dataclasses.dataclass(frozen=True)
class Groups:
    """Where K1's grouped entry finds the frames of each of S rows: row r's
    ``counts[r]`` frames from ``starts[r]``, then frames of weight 0 up to
    the next multiple of ``GROUP_UNIT``, where row r + 1 starts;
    ``n_frames`` in all.  On a card also the kernel's table (int32, the
    layout ``lia_em_stats_grouped_wgmma`` documents), ``chunk_len`` and
    ``n_chunks``."""

    starts: tuple[int, ...]
    counts: tuple[int, ...]
    n_frames: int
    chunk_len: int = 0
    n_chunks: int = 0
    table: torch.Tensor | None = None

    @property
    def pad_frames(self) -> int:
        """The frames of weight 0 that align the rows."""
        return self.n_frames - sum(self.counts)


def group_rows(counts, k: int, device) -> Groups:
    """The layout of rows of ``counts`` frames for K1's grouped entry with
    K = ``k`` components, and on a CUDA ``device`` its table there
    (``group_table``)."""
    counts = tuple(int(c) for c in counts)
    padded = [-(-c // GROUP_UNIT) * GROUP_UNIT for c in counts]
    starts = tuple(int(v) for v in np.cumsum([0] + padded[:-1]))
    n = sum(padded)
    if torch.device(device).type != "cuda" or n == 0:
        return Groups(starts, counts, n)
    chunk_len, n_chunks, table = group_table(padded, k)
    return Groups(starts, counts, n, chunk_len, n_chunks,
                  torch.as_tensor(table, device=device))


def group_table(padded, k: int) -> tuple[int, int, np.ndarray]:
    """(chunk_len, n_chunks, table) of rows of ``padded`` frames each (a
    multiple of ``GROUP_UNIT``, one row after another): each non-empty
    row cut into chunks of at most ``chunk_len`` frames
    (``stats_chunk_len`` of all the frames, rounded up to a multiple of
    ``GROUP_UNIT``), an empty row into none; the table as
    ``lia_em_stats_grouped_wgmma`` takes it."""
    n = sum(padded)
    chunk_len = -(-stats_chunk_len(n, k) // GROUP_UNIT) * GROUP_UNIT
    chunk_start, chunk_row, row_chunks = [], [], [0]
    s0 = 0
    for r, p in enumerate(padded):
        for c0 in range(s0, s0 + p, chunk_len):
            chunk_start.append(c0)
            chunk_row.append(r)
        row_chunks.append(len(chunk_row))
        s0 += p
    unit_row = np.repeat(np.arange(len(padded)),
                         np.asarray(padded, np.int64) // GROUP_UNIT)
    table = np.concatenate([chunk_start, [n], chunk_row, row_chunks,
                            unit_row]).astype(np.int32)
    return chunk_len, len(chunk_row), table


def _em_stats_grouped(x: torch.Tensor, w: torch.Tensor, bank: GmmDiag,
                      groups: Groups) -> EmStats:
    """``em_stats_fused`` with ``groups``: the plain version of each row
    on a CPU tensor, K1's grouped entry on a CUDA one."""
    s, k, d = bank.means.shape
    if len(groups.counts) != s:
        raise ValueError(f"em_stats_fused: {len(groups.counts)} rows for "
                         f"a bank of {s} models")
    if x.shape[0] != groups.n_frames:
        raise ValueError(f"em_stats_fused: {x.shape[0]} frames, the "
                         f"groups lay out {groups.n_frames}")
    if x.device.type == "cpu":
        return EmStats.stack([
            em_stats_reference(x[a:a + c], w[a:a + c], GmmDiag(
                bank.weights[r], bank.means[r], bank.cov_inv[r]))
            for r, (a, c) in enumerate(zip(groups.starts, groups.counts))])
    if not all(t.is_contiguous()
               for t in (bank.weights, bank.means, bank.cov_inv)):
        raise ValueError("em_stats_fused: the bank must be contiguous")
    _check_cuda_inputs("em_stats_fused", x, w,
                       GmmDiag(bank.weights[0], bank.means[0],
                               bank.cov_inv[0]))
    if groups.table is None or groups.table.device != x.device:
        raise ValueError("em_stats_fused: the groups have no table on "
                         f"{x.device} (group_rows on that device)")
    lib = _library(TIER_MODES[0])
    n = groups.n_frames
    with span("lia.gmm.em_stats_fused"):
        scratch = torch.empty((lib.lia_stats_grouped_scratch_bytes(
            n, d, k, s, groups.chunk_len, groups.n_chunks),),
            dtype=torch.uint8, device=x.device)
        out = torch.empty((s, k + 1, 2 * d + 2), dtype=torch.float32,
                          device=x.device)
        _launch("em_stats_fused", "em_stats_fused_grouped", x,
                lambda stream: lib.lia_em_stats_grouped_wgmma(
                    x.data_ptr(), w.data_ptr(), bank.weights.data_ptr(),
                    bank.means.data_ptr(), bank.cov_inv.data_ptr(), n, d, k,
                    s, groups.chunk_len, groups.n_chunks,
                    groups.table.data_ptr(), scratch.data_ptr(),
                    out.data_ptr(), stream))
    return EmStats(n=out[:, :k, 2 * d], sum_x=out[:, :k, d:2 * d],
                   sum_xx=out[:, :k, :d], llk=out[:, k, 0],
                   count=out[:, k, 1])


def bw_stats_fused(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag,
                   compute_dtype=None, mxu_precision: str = "bf16x3",
                   exp_mode: str = "exp2", stats_pass: str = "x3",
                   seed: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: per-utterance stats of a padded batch x (S,T,D), weights
    w (S,T), in the mode the JAX arguments name.  Returns (n (S,K),
    f (S,K,D), weighted llk (S,)).

    On CUDA one CTA owns one (utterance, 128-component block) and loops
    over all T frames itself, so no sum crosses CTAs."""
    mode = check_mode(compute_dtype, mxu_precision, exp_mode, stats_pass)
    seed = _seed64(seed)
    if x.device.type == "cpu":
        return bw_stats_reference(x, w, gmm, compute_dtype=compute_dtype,
                                  mxu_precision=mxu_precision,
                                  exp_mode=exp_mode, stats_pass=stats_pass,
                                  seed=seed)
    _check_cuda_inputs("bw_stats_fused", x, w, gmm)
    if x.dim() != 3:
        raise ValueError(f"bw_stats_fused: x must be (S,T,D), got "
                         f"{tuple(x.shape)}")
    lib = _library(mode)
    s, t, d = x.shape
    k = gmm.n_components
    lp, em, form, nx = mode.kernel_args()
    with span("lia.gmm.bw_stats_fused"):
        scratch = torch.empty((lib.lia_stats_scratch_bytes(
            s * t, d, k, t, s, 0, lp, form),), dtype=torch.uint8,
            device=x.device)
        out = torch.empty((s, k + 1, 2 * d + 2), dtype=torch.float32,
                          device=x.device)
        _launch("bw_stats_fused", _count_key("bw_stats_fused", mode), x,
                lambda stream: lib.lia_bw_stats_wgmma(
                    x.data_ptr(), w.data_ptr(), gmm.weights.data_ptr(),
                    gmm.means.data_ptr(), gmm.cov_inv.data_ptr(), s, t, d, k,
                    lp, em, form, nx, seed, scratch.data_ptr(),
                    out.data_ptr(), stream))
    return out[:, :k, 2 * d], out[:, :k, d:2 * d], out[:, k, 0]
