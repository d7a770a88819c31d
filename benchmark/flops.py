"""Operations and bytes of the benchmark's entries, as functions of the
cell's shapes alone (never of the program's tier or design), and the
card's published peaks.

Each logical product is counted once, whatever passes a kernel makes;
each input byte is read once and each output byte written once.  Peaks:
NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12        # tensor cores, bf16/fp16, dense
PEAK_HBM_BYTES = 3.35e12        # HBM3
F32 = 4


def k1_flops(n: int, k: int, d: int) -> float:
    """EM statistics of n weighted frames: the logits [x², x, 1]·B
    (2·n·K·(2D+1)) and the statistics pᵀ·[x², x, 1] (the same again)."""
    return 4.0 * n * k * (2 * d + 1)


def k1_bytes(n: int, k: int, d: int) -> float:
    """Frames and weights in, the GMM in, (n, Σx, Σx²) and llk out."""
    return F32 * (n * d + n + k * (2 * d + 1) + k * (2 * d + 1) + 2)


def k2_flops(n: int, k: int, d: int) -> float:
    """Baum-Welch statistics of n unpadded frames: the logits
    (2·n·K·(2D+1)) and the zero- and first-order statistics
    (2·n·K·(D+1))."""
    return 2.0 * n * k * (2 * d + 1) + 2.0 * n * k * (d + 1)


def k2_bytes(n: int, segments: int, k: int, d: int) -> float:
    """Unpadded frames and their weights in, the GMM in, (n, F) of every
    segment and its llk out."""
    return F32 * (n * d + n + k * (2 * d + 1)
                  + segments * k * (d + 1) + segments)


def extraction_flops(segments: int, k: int, d: int, r: int) -> float:
    """Exact i-vector extraction of a pass: per segment L = I + Σ n_c E_c
    (2·K·R²), T Σ⁻¹ F̄ (2·K·D·R) and a Cholesky solve (R³/3 + 2R²); once
    a pass E_c = T_c Σ_c⁻¹ T_cᵀ (2·K·R²·D)."""
    per_seg = 2.0 * k * r * r + 2.0 * k * d * r + r ** 3 / 3.0 + 2.0 * r * r
    return segments * per_seg + 2.0 * k * r * r * d


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    tf = flops / PEAK_BF16_FLOPS
    tb = nbytes / PEAK_HBM_BYTES
    return (tf, "flops") if tf >= tb else (tb, "bytes")
