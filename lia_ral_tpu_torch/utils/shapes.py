"""Shared shape-bucketing policy (copied from lia_ral_tpu/utils/shapes.py).

Ragged frame axes are padded to multiples of FRAME_BUCKET and batch axes
to powers of two, so batched calls see a small set of shapes."""

from __future__ import annotations

FRAME_BUCKET = 1024


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (1 for n ≤ 1)."""
    return 1 << max(n - 1, 0).bit_length()


def bucket_len(n: int, bucket: int = FRAME_BUCKET) -> int:
    """Smallest multiple of ``bucket`` ≥ max(n, 1)."""
    return -(-max(n, 1) // bucket) * bucket
