"""GmmDiag: the diagonal-covariance GMM (port of lia_ral_tpu/gmm/model.py).

Three dense tensors — ``weights (K,)``, ``means (K,D)``, ``cov_inv (K,D)``
(inverse variances) — with the log-space constants derived on demand,
and RAW/XML file IO through ``io.gmm_io``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..io.gmm_io import read_gmm_file, write_gmm_file

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class GmmDiag:
    """weights[K], means[K,D], cov_inv[K,D] (inverse variances)."""

    weights: torch.Tensor
    means: torch.Tensor
    cov_inv: torch.Tensor

    @property
    def n_components(self) -> int:
        return self.means.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def cov(self) -> torch.Tensor:
        return 1.0 / self.cov_inv

    def log_const(self) -> torch.Tensor:
        """Per-component log of the Gaussian normaliser:
        log cst_k = -0.5·(D·log2π − Σ_d log covInv_kd)."""
        return -0.5 * (self.dim * _LOG_2PI
                       - torch.sum(torch.log(self.cov_inv), dim=-1))

    def log_weights(self) -> torch.Tensor:
        return torch.log(self.weights)

    def replace(self, **changes) -> "GmmDiag":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "GmmDiag":
        return GmmDiag(self.weights.to(device), self.means.to(device),
                       self.cov_inv.to(device))

    def astype(self, dtype) -> "GmmDiag":
        return GmmDiag(self.weights.to(dtype), self.means.to(dtype),
                       self.cov_inv.to(dtype))

    # -- constructors -------------------------------------------------------
    @classmethod
    def create(cls, weights, means, cov_inv, dtype=torch.float32,
               device=None) -> "GmmDiag":
        return cls(weights=torch.as_tensor(weights, dtype=dtype,
                                           device=device),
                   means=torch.as_tensor(means, dtype=dtype, device=device),
                   cov_inv=torch.as_tensor(cov_inv, dtype=dtype,
                                           device=device))

    @classmethod
    def from_cov(cls, weights, means, cov, dtype=torch.float32,
                 device=None) -> "GmmDiag":
        cov = torch.as_tensor(cov, dtype=dtype, device=device)
        return cls.create(weights, means, 1.0 / cov, dtype, device)

    # -- file IO (host side) -------------------------------------------------
    @classmethod
    def load(cls, path: str, fmt: str | None = None, dtype=torch.float32,
             device=None) -> "GmmDiag":
        """Read a RAW or XML mixture file (``fmt`` None: sniff the file)."""
        w, m, ci = read_gmm_file(path, fmt)
        return cls.create(w, m, ci, dtype, device)

    def save(self, path: str, fmt: str = "RAW", model_id: str = "#1") -> None:
        """Write the mixture as RAW or XML (values widened to f64, as the
        JAX package writes them, so a RAW round trip is bit-exact)."""
        def f64(t):
            return t.detach().cpu().numpy().astype(np.float64)
        write_gmm_file(path, f64(self.weights), f64(self.means),
                       f64(self.cov_inv), fmt=fmt, model_id=model_id)

    @classmethod
    def uniform_init(cls, k: int, d: int, dtype=torch.float32,
                     device=None) -> "GmmDiag":
        """Unit-variance zero-mean equal-weight init (ALIZE fresh MixtureGD)."""
        return cls(weights=torch.full((k,), 1.0 / k, dtype=dtype,
                                      device=device),
                   means=torch.zeros((k, d), dtype=dtype, device=device),
                   cov_inv=torch.ones((k, d), dtype=dtype, device=device))
