"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are drawn with numpy from a seeded generator and handed to both
packages, so the JAX reference and the port compute from identical
values.  Torch is capped at two threads because the suite runs under
several xdist workers at once.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# CPU budgets of the JAX suite's own kernel-vs-reference checks
# (tests/test_pallas_kernel.py:35-46 and :153-163), used for every
# stats comparison of the port against the JAX package.
N_TOL = dict(rtol=1e-4, atol=1e-4)        # occupancies n
SUM_TOL = dict(rtol=1e-3, atol=1e-3)      # first/second-order sums
LLK_RTOL = 1e-5                           # summed weighted llk
COUNT_RTOL = 1e-6                         # summed weights


def random_gmm_np(rng: np.random.Generator, k: int, d: int):
    """(weights, means, cov_inv) as float32 numpy arrays."""
    w = rng.random(k) + 0.5
    w /= w.sum()
    return (w.astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32),
            (rng.random((k, d)) + 0.5).astype(np.float32))


def both_gmms(rng: np.random.Generator, k: int, d: int):
    """The same random GMM as a JAX-package and a port GmmDiag."""
    from lia_ral_tpu.gmm import GmmDiag as JGmm
    from lia_ral_tpu_torch.convert import gmm_from_numpy

    w, m, ci = random_gmm_np(rng, k, d)
    return JGmm.create(w, m, ci), gmm_from_numpy(w, m, ci)


def np_of(a) -> np.ndarray:
    """A JAX array or a torch tensor as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_em_stats_close(got, want) -> None:
    """EmStats of either package against EmStats of either package."""
    np.testing.assert_allclose(np_of(got.n), np_of(want.n), **N_TOL)
    np.testing.assert_allclose(np_of(got.sum_x), np_of(want.sum_x),
                               **SUM_TOL)
    np.testing.assert_allclose(np_of(got.sum_xx), np_of(want.sum_xx),
                               **SUM_TOL)
    np.testing.assert_allclose(float(got.llk), float(want.llk),
                               rtol=LLK_RTOL)
    np.testing.assert_allclose(float(got.count), float(want.count),
                               rtol=COUNT_RTOL)


def assert_close_scaled(got, want, rtol: float, err_msg: str = "") -> None:
    """rtol with atol = rtol·max|want|: the budget of an array whose small
    entries carry the absolute error of its large ones (a product, a
    solve)."""
    got, want = np_of(got), np_of(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))),
                               err_msg=err_msg)


# Invariants of quantities that two LAPACKs give in different bases: an
# eigenvector's sign (and the basis of a repeated eigenvalue), a QR
# factor's column signs.

def gram(x) -> np.ndarray:
    """X·Xᵀ of row vectors: equal for X and X·O with any orthogonal O
    (vectors normalised through M and through O·M)."""
    x = np_of(x).astype(np.float64)
    return x @ x.T


def metric(m) -> np.ndarray:
    """MᵀM of a transform applied as x @ Mᵀ: equal for M and O·M (a
    whitening matrix M = Λ^-½·Vᵀ has MᵀM = Σ⁻¹ whatever V's signs)."""
    m = np_of(m).astype(np.float64)
    return m.T @ m


def projector(rows) -> np.ndarray:
    """Orthogonal projector onto the row space of P: Pᵀ(PPᵀ)⁻¹P, equal
    for any two bases of the same space, whatever their signs, order or
    scaling."""
    p = np_of(rows).astype(np.float64)
    return p.T @ np.linalg.solve(p @ p.T, p)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)
