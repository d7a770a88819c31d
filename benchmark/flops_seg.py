"""Operations and bytes of the diarization cell's entries, as functions of
its shapes alone (``benchmark/flops.py`` holds K1's and the card's peaks).

The Viterbi kernel: a step takes, for each of S target states, the
largest of S sums δ(i) + log a(i, j): S² adds and as many comparisons,
N·S² each over N frames.  Its bytes: the emissions in (N·S float32), the
path out (N int64), the transitions in (S² float32), each once.  S is
the states in the HMM: the E-HMM's padding rows and ReSegmentation's
dropped states (emissions of −1e30) are not its work.

A decode's emission block: each frame against each of the S states' K
components, 2·(2D + 1) flops a pair (the logits [x², x, 1]·B and their
weight), as K1 counts its logits.
"""

from __future__ import annotations

from benchmark.flops import F32

I64 = 8


def viterbi_ops(n: int, s: int) -> float:
    """N·S² adds and N·S² comparisons."""
    return 2.0 * n * s * s


def viterbi_bytes(n: int, s: int) -> float:
    """Emissions in, the path out, the transitions in."""
    return F32 * n * s + I64 * n + F32 * s * s


def emission_flops(n: int, s: int, k: int, d: int) -> float:
    """N frames against S states of K components: N·S·K·2(2D + 1)."""
    return n * s * k * 2.0 * (2 * d + 1)
