"""i-vector normalisation: length-norm, EFR/sphNorm, LDA, WCCN, Mahalanobis
(port of lia_ral_tpu/backend/ivnorm.py).

Equivalent of reference ``PldaDev`` (PldaTools.cpp): lengthNorm (cpp:436),
center (cpp:466), computeCovMat (cpp:516-754, total/within/between
scatter), computeWccnChol (cpp:1113), computeMahalanobis (cpp:1366),
computeLDA (cpp:1381), sphericalNuisanceNormalization (cpp:1822-1928, the
EFR and sphNorm iterations of {cov → eig → whiten → center →
length-norm}).

A dev set is (vectors (N,R), speaker ids (N,)).  Sessions are summed into
speakers by a one-hot (N,S) product: its order of summation is fixed, so
a rerun on the same device reproduces every digit (a scatter-add with
atomics would not).  The whitening and LDA matrices come from ``eigh``:
their rows are defined up to sign (and up to a rotation inside a repeated
eigenvalue's space), so two LAPACKs agree on MᵀM and on scores, not on M.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DevSet:
    """Development i-vectors with speaker labels."""

    vectors: torch.Tensor      # (N, R)
    spk_ids: torch.Tensor      # (N,) int64 in [0, n_speakers)
    n_speakers: int

    @classmethod
    def from_labels(cls, vectors, labels: list[str],
                    device=None) -> "DevSet":
        """Speaker ids in order of first appearance.  ``vectors``: a
        tensor (its device is kept unless ``device`` is given) or an
        array."""
        uniq: dict[str, int] = {}
        ids = [uniq.setdefault(lab, len(uniq)) for lab in labels]
        vec = torch.as_tensor(vectors, dtype=torch.float32, device=device)
        return cls(vec, torch.as_tensor(np.asarray(ids, np.int64),
                                        device=vec.device), len(uniq))

    def replace(self, **changes) -> "DevSet":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "DevSet":
        return DevSet(self.vectors.to(device), self.spk_ids.to(device),
                      self.n_speakers)


def one_hot(ids: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """(N, n) indicator matrix of integer ids."""
    return torch.nn.functional.one_hot(ids.to(torch.int64), n).to(dtype)


def length_norm(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| (reference lengthNorm, cpp:436)."""
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def compute_cov_matrices(dev: DevSet
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Sigma total, W within, B between) — reference computeCovMat
    (cpp:516-560); all divided by the session count."""
    x = dev.vectors
    n = x.shape[0]
    mean = torch.mean(x, dim=0)
    xc = x - mean
    sigma = (xc.T @ xc) / n
    hot = one_hot(dev.spk_ids, dev.n_speakers, x.dtype)
    counts = torch.clamp(hot.sum(dim=0), min=1.0)             # (S,)
    spk_means = (hot.T @ x) / counts[:, None]                 # (S,R)
    xw = x - spk_means[dev.spk_ids]
    w = (xw.T @ xw) / n
    bm = spk_means - mean[None, :]
    b = ((bm * counts[:, None]).T @ bm) / n
    return sigma, w, b


def _inv_sqrt(mat: torch.Tensor, floor: float = 1e-12) -> torch.Tensor:
    """M^(-1/2) by eigendecomposition: the rows of the result are the
    whitening transform the reference stores (sphNormMat = (V·Λ^-½)ᵀ).
    ``floor`` clips the eigenvalues before the inverse square root."""
    vals, vecs = torch.linalg.eigh(mat)
    return (vecs * (1.0 / torch.sqrt(torch.clamp(vals, min=floor)))[None, :]).T


def efr_iterations(dev: DevSet, n_iterations: int = 1, mode: str = "EFR"
                   ) -> tuple[torch.Tensor,
                              list[tuple[torch.Tensor, torch.Tensor]]]:
    """EFR / spherical nuisance normalisation on the dev set.

    Reference sphericalNuisanceNormalization (cpp:1822-1928): iterate
    {compute Σ (EFR) or W (sphNorm) → M=Σ^-½ → center → rotate →
    length-norm}.  Returns the normalised vectors and the list of
    (mean, M) per iteration needed to apply the same transform to test
    vectors (applySphericalNuisanceNormalization, cpp:1931).
    """
    x = dev.vectors
    n, r = x.shape
    params: list[tuple[torch.Tensor, torch.Tensor]] = []
    for _ in range(n_iterations):
        sigma, w, _ = compute_cov_matrices(dev.replace(vectors=x))
        cov = w if mode == "sphNorm" else sigma
        # A dev set smaller than the vector dimension gives a singular
        # covariance; whitening would amplify pure estimation noise in
        # the null space by ~1/√ε.  The reference assumes dev ≫ R and
        # never guards (PldaTools.cpp:1822-1928); here the null directions
        # are floored at the mean eigenvalue trace/R, so they pass through
        # at a typical scale.
        floor = float(torch.trace(cov)) / r if n - 1 < r else 1e-12
        m = _inv_sqrt(cov, floor)
        mean = torch.mean(x, dim=0)
        params.append((mean, m))
        x = length_norm((x - mean[None, :]) @ m.T)
    return x, params


def apply_efr(x: torch.Tensor,
              params: list[tuple[torch.Tensor, torch.Tensor]]
              ) -> torch.Tensor:
    """Apply recorded EFR transforms to new vectors."""
    for mean, m in params:
        x = length_norm((x - mean[None, :]) @ m.T)
    return x


def _regularised(w: torch.Tensor) -> torch.Tensor:
    """W + 1e-6·I: the within-class covariance as the LDA, WCCN and
    Mahalanobis transforms invert it."""
    return w + 1e-6 * torch.eye(w.shape[0], dtype=w.dtype, device=w.device)


def compute_lda(dev: DevSet, rank: int) -> torch.Tensor:
    """LDA projection (reference computeLDA, cpp:1381): top generalised
    eigenvectors of W⁻¹B, returned as (rank, R) projection rows."""
    _, w, b = compute_cov_matrices(dev)
    # the symmetric generalised problem through W^-1/2
    wis = _inv_sqrt(_regularised(w))
    _, vecs = torch.linalg.eigh(wis @ b @ wis.T)
    top = torch.flip(vecs, dims=(1,))[:, :rank]    # descending eigenvalues
    return (wis.T @ top).T                         # (rank, R)


def compute_wccn(dev: DevSet) -> torch.Tensor:
    """WCCN Cholesky transform (reference computeWccnChol, cpp:1113):
    W⁻¹ = L·Lᵀ, returns Lᵀ (apply as x @ L)."""
    w_inv = torch.linalg.inv(_regularised(compute_cov_matrices(dev)[1]))
    return torch.linalg.cholesky(w_inv).T


def compute_mahalanobis(dev: DevSet) -> torch.Tensor:
    """Within-class Mahalanobis metric W⁻¹ (reference computeMahalanobis,
    cpp:1366)."""
    return torch.linalg.inv(_regularised(compute_cov_matrices(dev)[1]))
