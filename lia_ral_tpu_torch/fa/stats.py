"""Baum-Welch sufficient statistics (N, F) per utterance (port of
lia_ral_tpu/fa/stats.py).

Reference ``computeAndAccumulateTVStat`` (AccumulateTVStat.cpp:281-351).
Utterances are processed as padded (S, T, D) batches with (S, T) masks.
``bw_stats_bucketed`` packs each batch's own frames back to back in one
of two host staging slots (page-locked for a CUDA GMM, so the copy of one
batch runs under the stats of the one before) and pads the batch on the
GMM's device.  For CUDA tensors the batch goes through kernel K2
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


class _Staging:
    """Two slots between the host arrays and the GMM's device, each as
    large as the largest packed batch.  On a card a slot is a page-locked
    host buffer and a device buffer; its copy goes out on a stream of its
    own, and events order it: the compute stream waits for a slot's copy
    before it reads the slot, the copy into a device slot waits until the
    compute stream has read that slot's last batch, and the host waits
    for a slot's copy before it packs the slot again.  On the CPU a slot
    is one unpinned buffer, read in place."""

    def __init__(self, device: torch.device, size: int, n_slots: int):
        self.cuda = device.type == "cuda"
        self.host = [torch.empty(size, dtype=torch.float32,
                                 pin_memory=self.cuda)
                     for _ in range(n_slots)]
        self.pinned = self.cuda and self.host[0].is_pinned()
        self.turn = 0
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.copier = torch.cuda.Stream(device)
            self.dev = [torch.empty(size, dtype=torch.float32, device=device)
                        for _ in range(n_slots)]
            # the device slots may reuse memory that work queued on the
            # compute stream still reads: no copy starts before that work
            self.copier.wait_stream(self.compute)
            self.copied = [torch.cuda.Event() for _ in range(n_slots)]
            self.read = [torch.cuda.Event() for _ in range(n_slots)]

    def claim(self) -> np.ndarray:
        """The next slot's host buffer, once its last copy has left it."""
        s = self.turn % len(self.host)
        if self.cuda and not self.copied[s].query():
            count("lia.stats.slot_waits")
            self.copied[s].synchronize()
        return self.host[s].numpy()

    def send(self, size: int) -> torch.Tensor:
        """The first ``size`` values of the slot just packed, on the
        device: one asynchronous copy on a card."""
        s = self.turn % len(self.host)
        if not self.cuda:
            return self.host[s][:size]
        with torch.cuda.stream(self.copier):
            self.copier.wait_event(self.read[s])
            self.dev[s][:size].copy_(self.host[s][:size], non_blocking=True)
            self.copied[s].record(self.copier)
        self.compute.wait_event(self.copied[s])
        return self.dev[s][:size]

    def release(self) -> None:
        """Every read of the slot just sent is queued: the next turn."""
        if self.cuda:
            self.read[self.turn % len(self.host)].record(self.compute)
        self.turn += 1


def _pack(buf: np.ndarray, rows, d: int) -> tuple[int, int]:
    """Pack ``rows`` ((x (T,D), mask (T,)) pairs) into ``buf``: their
    frames back to back, then their mask values, then the rows' offsets
    (int32, one more than the rows).  Returns (frames, values) packed."""
    lens = [x.shape[0] for x, _ in rows]
    carried = sum(lens)
    frames = buf[:carried * d].reshape(carried, d)
    mask = buf[carried * d:carried * (d + 1)]
    a = 0
    for (x, m), n in zip(rows, lens):
        frames[a:a + n] = x
        mask[a:a + n] = m
        a += n
    size = carried * (d + 1) + len(rows) + 1
    buf[carried * (d + 1):size].view(np.int32)[:] = np.cumsum([0] + lens)
    return carried, size


def _pad(packed: torch.Tensor, rows: int, carried: int, b_pad: int,
         plen: int, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (b_pad, plen, D) frames and (b_pad, plen) mask of a packed
    batch, zero after each row's frames and in the rows past ``rows``,
    built on the packed batch's device with no read back to the host."""
    dev = packed.device
    offs = packed[carried * (d + 1):].view(torch.int32).long()
    starts = torch.arange(rows, device=dev) * plen - offs[:-1]
    dest = (torch.repeat_interleave(starts, offs[1:] - offs[:-1],
                                    output_size=carried)
            + torch.arange(carried, device=dev))
    x = torch.zeros((b_pad * plen, d), dtype=torch.float32, device=dev)
    x.index_copy_(0, dest, packed[:carried * d].view(carried, d))
    m = torch.zeros(b_pad * plen, dtype=torch.float32, device=dev)
    m.index_copy_(0, dest, packed[carried * d:carried * (d + 1)])
    return x.view(b_pad, plen, d), m.view(b_pad, plen)


def bw_stats_bucketed(entries, gmm: GmmDiag, bucket: int = 2048,
                      batch_size: int = 64,
                      stats_pass: str = "x3") -> BwStats:
    """Stats of ragged utterances via length-bucketed padded batches.

    entries: list of (x (T_i,D) ndarray, mask (T_i,) ndarray).  Each
    utterance is padded to a multiple of ``bucket`` frames and grouped
    with same-padded-length peers into (batch, T, D) ``bw_stats_batch``
    calls on the GMM's device; the batch axis is padded to a power of two
    with zero-weight utterances.  Row order == input order.

    The host packs a batch's own frames and mask values (cast to float32)
    back to back into one of two staging slots (``_Staging``), with the
    rows' offsets; one copy takes the slot to the device, where the
    padded batch is built (``_pad``).  On a card the slots are
    page-locked and the copy asynchronous, so the host packs the next
    batch while this one is copied and its stats run.

    Traced (``utils.logging``): spans ``lia.stats.pad`` (packing a slot
    on the host), ``lia.stats.h2d`` (the slot's copy to the device),
    ``lia.stats.batch`` (the padded batch built on the device and its
    stats call: K2 on a card), ``lia.stats.gather`` (rows out, the final
    stack); counters ``lia.stats.batches``, ``frames_sent`` (rows ×
    padded length), ``frames_carried`` (the utterances' own frames),
    ``h2d_bytes`` (the packed slots: carried frames × (D + 1) × 4, and
    the offsets), ``pinned_batches`` (batches sent from page-locked
    memory) and ``slot_waits`` (packs that waited for their slot's copy).
    """
    if not entries:
        raise ValueError("bw_stats_bucketed: no readable sessions "
                         "(every utterance of the list failed to load)")
    for i, (x, m) in enumerate(entries):
        if m.shape[0] != x.shape[0]:
            raise ValueError(f"bw_stats_bucketed: utterance {i} has "
                             f"{x.shape[0]} frames and {m.shape[0]} mask "
                             "values")
    with span("lia.fa.bw_stats_bucketed"):
        d = gmm.dim
        rows_n: list = [None] * len(entries)
        rows_f: list = [None] * len(entries)
        by_len: dict[int, list[int]] = {}
        for i, (x, _) in enumerate(entries):
            by_len.setdefault(bucket_len(x.shape[0], bucket), []).append(i)
        batches = [(plen, idxs[s0:s0 + batch_size])
                   for plen, idxs in by_len.items()
                   for s0 in range(0, len(idxs), batch_size)]
        stage = _Staging(gmm.device, max(
            sum(entries[i][0].shape[0] for i in grp) * (d + 1) + len(grp) + 1
            for _, grp in batches), min(len(batches), 2))
        for plen, grp in batches:
            b_pad = next_pow2(len(grp))
            buf = stage.claim()
            with span("lia.stats.pad"):
                carried, size = _pack(buf, [entries[i] for i in grp], d)
            with span("lia.stats.h2d"):
                packed = stage.send(size)
            count("lia.stats.batches")
            count("lia.stats.frames_sent", b_pad * plen)
            count("lia.stats.frames_carried", carried)
            count("lia.stats.h2d_bytes", 4 * size)
            count("lia.stats.pinned_batches", int(stage.pinned))
            with span("lia.stats.batch"):
                xd, md = _pad(packed, len(grp), carried, b_pad, plen, d)
                stage.release()
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
