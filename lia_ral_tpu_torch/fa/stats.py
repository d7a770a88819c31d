"""Baum-Welch sufficient statistics (N, F) per utterance (port of
lia_ral_tpu/fa/stats.py).

Reference ``computeAndAccumulateTVStat`` (AccumulateTVStat.cpp:281-351).
Utterances are processed as padded (S, T, D) batches with (S, T) masks.
For CUDA tensors the batch goes through kernel K2
(``gmm.cuda_kernels.bw_stats_fused``); for CPU tensors through its plain
version, in the arithmetic ``stats_pass`` names (any value of the JAX
kernel's: ``gmm.cuda_kernels`` lists them).  Stats checkpoint as ``.npz``
and as ALIZE ``.matx`` matrices (the reference's saveAccs layout).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gmm.cuda_kernels import bw_stats_fused, bw_stats_reference, check_mode
from ..gmm.kernels import llk_and_posteriors
from ..gmm.model import GmmDiag
from ..io.matrix import read_matrix_file, write_matrix_file
from ..utils.logging import count, span
from ..utils.shapes import bucket_len, next_pow2


@dataclasses.dataclass(frozen=True)
class BwStats:
    """Zero- and first-order Baum-Welch stats per utterance.

    n: (S, K) occupancy; f: (S, K, D) raw first-order sums (centering by
    the UBM mean happens in the consumer, as the reference's substractM).
    """

    n: torch.Tensor
    f: torch.Tensor

    @property
    def n_utts(self) -> int:
        return self.n.shape[0]

    def merge(self, other: "BwStats") -> "BwStats":
        """Concatenate along the utterance axis."""
        return BwStats(n=torch.cat([self.n, other.n]),
                       f=torch.cat([self.f, other.f]))

    def centered(self, ubm_means: torch.Tensor) -> torch.Tensor:
        """F̄ = F − N·m (reference substractM, AccumulateTVStat.cpp:1078)."""
        return self.f - self.n[..., None] * ubm_means[None, :, :]

    def normalized(self, ubm_means: torch.Tensor,
                   ubm_inv_var: torch.Tensor) -> torch.Tensor:
        """F̄·sqrt(Σ⁻¹) (reference normStatistics, cpp:1215)."""
        return self.centered(ubm_means) * torch.sqrt(ubm_inv_var)[None]

    def to(self, device) -> "BwStats":
        return BwStats(n=self.n.to(device), f=self.f.to(device))


def accumulate_bw_stats(x: torch.Tensor, w: torch.Tensor, gmm: GmmDiag
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stats of ONE utterance: x (T,D), w (T,) → (n (K,), f (K,D))."""
    _, post = llk_and_posteriors(x, gmm)
    pw = post * w[:, None]
    return torch.sum(pw, dim=0), pw.T @ x


def bw_stats_batch(x: torch.Tensor, mask: torch.Tensor, gmm: GmmDiag,
                   use_fused: bool | None = None,
                   stats_pass: str = "x3") -> BwStats:
    """Stats of a padded utterance batch: x (S,T,D), mask (S,T).

    ``use_fused=None`` picks kernel K2 for a CUDA tensor and the plain
    version for a CPU one; ``use_fused=False`` asks for the plain version
    on any device.  ``stats_pass`` is any of the kernel's
    (``"bf16nx"`` is the fastStats tier)."""
    check_mode(stats_pass=stats_pass)
    if use_fused is None:
        use_fused = x.device.type == "cuda"
    if use_fused:
        n, f, _ = bw_stats_fused(x, mask, gmm, stats_pass=stats_pass)
    else:
        n, f, _ = bw_stats_reference(x, mask, gmm, stats_pass=stats_pass)
    return BwStats(n=n, f=f)


def bw_stats_bucketed(entries, gmm: GmmDiag, bucket: int = 2048,
                      batch_size: int = 64,
                      stats_pass: str = "x3") -> BwStats:
    """Stats of ragged utterances via length-bucketed padded batches.

    entries: list of (x (T_i,D) ndarray, mask (T_i,) ndarray).  Each
    utterance is padded to a multiple of ``bucket`` frames and grouped
    with same-padded-length peers into (batch, T, D) ``bw_stats_batch``
    calls on the GMM's device; the batch axis is padded to a power of two
    with zero-weight utterances.  Row order == input order.

    Traced (``utils.logging``): spans ``lia.stats.pad`` (host arrays),
    ``lia.stats.h2d`` (their copy to the device), ``lia.stats.batch``
    (the batch's stats call: K2 on a card), ``lia.stats.gather`` (rows
    out, the final stack); counters ``lia.stats.batches``,
    ``frames_sent`` (rows × padded length), ``frames_carried`` (the
    utterances' own frames) and ``h2d_bytes``.
    """
    if not entries:
        raise ValueError("bw_stats_bucketed: no readable sessions "
                         "(every utterance of the list failed to load)")
    with span("lia.fa.bw_stats_bucketed"):
        d = gmm.dim
        rows_n: list = [None] * len(entries)
        rows_f: list = [None] * len(entries)
        by_len: dict[int, list[int]] = {}
        for i, (x, _) in enumerate(entries):
            by_len.setdefault(bucket_len(x.shape[0], bucket), []).append(i)
        for plen, idxs in by_len.items():
            for s0 in range(0, len(idxs), batch_size):
                grp = idxs[s0:s0 + batch_size]
                b_pad = next_pow2(len(grp))
                with span("lia.stats.pad"):
                    xs = np.zeros((b_pad, plen, d), np.float32)
                    ms = np.zeros((b_pad, plen), np.float32)
                    carried = 0
                    for j, i in enumerate(grp):
                        x, m = entries[i]
                        xs[j, :x.shape[0]] = x
                        ms[j, :m.shape[0]] = m
                        carried += x.shape[0]
                with span("lia.stats.h2d"):
                    xd = torch.from_numpy(xs).to(gmm.device)
                    md = torch.from_numpy(ms).to(gmm.device)
                count("lia.stats.batches")
                count("lia.stats.frames_sent", b_pad * plen)
                count("lia.stats.frames_carried", carried)
                count("lia.stats.h2d_bytes", xs.nbytes + ms.nbytes)
                with span("lia.stats.batch"):
                    st = bw_stats_batch(xd, md, gmm, stats_pass=stats_pass)
                with span("lia.stats.gather"):
                    for j, i in enumerate(grp):
                        rows_n[i] = st.n[j]
                        rows_f[i] = st.f[j]
        with span("lia.stats.gather"):
            return BwStats(n=torch.stack(rows_n), f=torch.stack(rows_f))


def save_stats(path: str, stats: BwStats, names: list[str] | None = None
               ) -> None:
    np.savez(path,
             n=stats.n.detach().cpu().numpy(),
             f=stats.f.detach().cpu().numpy(),
             names=np.asarray(names if names is not None else [],
                              dtype=object))


def load_stats(path: str, device=None) -> tuple[BwStats, list[str]]:
    z = np.load(path, allow_pickle=True)
    return (BwStats(n=torch.as_tensor(z["n"], device=device),
                    f=torch.as_tensor(z["f"], device=device)),
            list(z["names"]))


def save_stats_matx(prefix: str, stats: BwStats, fmt: str = "DB") -> None:
    """ALIZE-interop checkpoint: <prefix>_N.matx (S,K) and <prefix>_F_X.matx
    (S, K·D) — the reference's saveAccs layout."""
    s, k, d = stats.f.shape
    n = stats.n.detach().cpu().numpy().astype(np.float64)
    f = stats.f.detach().cpu().numpy().astype(np.float64)
    write_matrix_file(prefix + "_N.matx", n, fmt)
    write_matrix_file(prefix + "_F_X.matx", f.reshape(s, k * d), fmt)


def load_stats_matx(prefix: str, vect_size: int, device=None) -> BwStats:
    n = read_matrix_file(prefix + "_N.matx")
    f = read_matrix_file(prefix + "_F_X.matx")
    s, k = n.shape
    return BwStats(
        n=torch.as_tensor(n, dtype=torch.float32, device=device),
        f=torch.as_tensor(f.reshape(s, k, vect_size), dtype=torch.float32,
                          device=device))
