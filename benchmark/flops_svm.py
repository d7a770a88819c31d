"""Operations and bytes of the GMM-SVM cell's entries, as functions of its
shapes alone (``benchmark/flops.py`` holds K1's and the card's peaks).

The dual solve of N training vectors (``svm_dual``, FISTA): 16 power
steps, one Rayleigh quotient and ``steps`` gradient steps, each a
matrix-vector product with Q (2·N² operations), and ``steps`` + 1
projections, each a 50-step bisection of about 3 operations a vector a
step (the clip to [0, C] and the product with y of each candidate).  Its
bytes are the algorithm's least: the kernel matrix in once (4·N²), y and
C in and α out (4·N each), whatever implements it.

The rest of a pass, for ``mfu.svm``: each target's Gram of N vectors of
width W (2·N²·W), NAP of a side against a rank-r subspace (4·W·r: the
projection and its removal) and a decision of one test vector against
|SV| support vectors (2·|SV|·W).
"""

from __future__ import annotations

from benchmark.flops import F32

POWER_STEPS, BISECTION_STEPS = 16, 50


def dual_ops_summed(q_entries: int, steps_q: int, vectors: int,
                    steps_vectors: int) -> float:
    """``dual_ops`` summed over solves, from the sums ΣN², Σsteps·N², ΣN
    and Σsteps·N (the program's ``lia.svm.*`` counters)."""
    return (2.0 * ((POWER_STEPS + 1) * q_entries + steps_q)
            + 3.0 * BISECTION_STEPS * (steps_vectors + vectors))


def dual_ops(n: int, steps: int) -> float:
    """(16 + 1 + steps) products with Q and steps + 1 bisections."""
    return dual_ops_summed(n * n, steps * n * n, n, steps * n)


def dual_bytes_summed(q_entries: int, vectors: int) -> float:
    """``dual_bytes`` summed over solves, from ΣN² and ΣN."""
    return F32 * (q_entries + 3 * vectors)


def dual_bytes(n: int) -> float:
    """K in once, y and C in, α out."""
    return dual_bytes_summed(n * n, n)


def gram_flops(n: int, width: int) -> float:
    """The linear kernel matrix of N vectors: 2·N²·W."""
    return 2.0 * n * n * width


def nap_flops(width: int, rank: int) -> float:
    """v·Uᵀ and its product with U, for one vector: 4·W·r."""
    return 4.0 * width * rank


def decision_flops(support: int, width: int) -> float:
    """One test vector against |SV| support vectors: 2·|SV|·W."""
    return 2.0 * support * width
