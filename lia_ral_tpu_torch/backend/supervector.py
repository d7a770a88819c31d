"""GMM supervectors, NAP projection, Fisher/KL kernels, NAP training (port
of lia_ral_tpu/backend/supervector.py).

Equivalent of reference ``LIA_SpkTools/SuperVectors`` (SuperVectors.cpp):
modelToSv/svToModel (cpp:70-86), projectOnSubSpace (cpp:108-126),
computeNap (cpp:128-138), getFisherWeightVector (cpp:240), getKLVector
(cpp:253), getSuperVector dispatch (cpp:266) — plus the NAP-subspace
training of ``LIA_SpkDet/CovIntra`` (CovIntra.cpp:257: within-class
covariance top eigenvectors via SVDLIBC Lanczos → here an SVD of the
speaker-centred matrix).  Every function computes on its inputs' device.
NAP's projection and its training are spans of ``utils.logging``
(``lia.sv.nap``, ``lia.sv.nap_train``), on only while a profiler records.
"""

from __future__ import annotations

import torch

from ..gmm.model import GmmDiag
from ..utils.logging import span


def model_to_sv(gmm: GmmDiag) -> torch.Tensor:
    """Concatenated means (K·D,) (reference modelToSv, cpp:70)."""
    return gmm.means.reshape(-1)


def sv_to_model(sv: torch.Tensor, gmm: GmmDiag) -> GmmDiag:
    """Replace a model's means from a supervector (reference svToModel)."""
    return gmm.replace(means=sv.reshape(gmm.means.shape))


def project_on_subspace(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """U·(Uᵀ·x) — the channel-subspace component of x (reference
    projectOnSubSpace, cpp:108; rows of ``u`` span the subspace)."""
    return (x @ u.T) @ u


def compute_nap(gmm: GmmDiag, u: torch.Tensor) -> GmmDiag:
    """Remove the nuisance-subspace component from a model's mean
    supervector (reference computeNap, cpp:128-138)."""
    sv = model_to_sv(gmm)
    return sv_to_model(sv - project_on_subspace(sv[None, :], u)[0], gmm)


def nap_project_vectors(vectors: torch.Tensor, u: torch.Tensor
                        ) -> torch.Tensor:
    """Batched NAP on raw supervectors (reference NAPSV utility)."""
    with span("lia.sv.nap"):
        return vectors - project_on_subspace(vectors, u)


def fisher_weight_vector(world: GmmDiag, client: GmmDiag) -> torch.Tensor:
    """Weight-ratio Fisher vector c_k/w_k (reference
    getFisherWeightVector, cpp:240-249; 'SVMUBM' supervector)."""
    return client.weights / world.weights


def kl_vector(model: GmmDiag) -> torch.Tensor:
    """KL-kernel supervector μ_kd·sqrt(w_k·covInv_kd) (reference
    getKLVector, cpp:253-265)."""
    scale = torch.sqrt(model.weights[:, None] * model.cov_inv)
    return (model.means * scale).reshape(-1)


def get_supervector(mode: str, world: GmmDiag, client: GmmDiag
                    ) -> torch.Tensor:
    """Reference getSuperVector dispatch (cpp:266-277): SVMUBM | KL."""
    if mode == "SVMUBM":
        return fisher_weight_vector(world, client)
    if mode == "KL":
        return kl_vector(client)
    raise ValueError("Cannot find supervector mode [KL|SVMUBM]")


def train_nap_subspace(vectors: torch.Tensor, spk_ids: torch.Tensor,
                       n_speakers: int, rank: int) -> torch.Tensor:
    """NAP / within-class covariance subspace (reference CovIntra.cpp:
    151-280): top-``rank`` eigenvectors of the within-speaker scatter of
    the supervectors, via SVD of the speaker-centred matrix (replacing
    SVDLIBC svdLAS2).  Returns (rank, dim) with orthonormal rows; their
    signs are the solver's (compare subspaces through their projector)."""
    with span("lia.sv.nap_train"):
        spk_ids = spk_ids.to(device=vectors.device, dtype=torch.long)
        one_hot = torch.nn.functional.one_hot(spk_ids, n_speakers).to(
            vectors.dtype)
        counts = torch.clamp(one_hot.sum(dim=0), min=1.0)
        means = (one_hot.T @ vectors) / counts[:, None]
        centered = vectors - means[spk_ids]
        # right singular vectors of the centred matrix = eigenvectors of
        # the within-class scatter
        _, _, vt = torch.linalg.svd(centered, full_matrices=False)
        return vt[:rank]
