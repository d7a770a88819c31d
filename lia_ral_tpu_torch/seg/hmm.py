"""HMM container + Viterbi decoding for diarization (port of
lia_ral_tpu/seg/hmm.py).

Equivalent of reference ``LIA_SpkTools/Hmm`` (include/Hmm.h:74-121:
states = GMMs + transition matrix) and the ALIZE ViterbiAccum consumed by
``viterbiDecoding`` (Tools.cpp:1021).  The emission matrix is one batched
GMM pass over the stacked states; the frame-sequential Viterbi recursion
is a hand-written CUDA kernel for CUDA tensors (``viterbi_cuda``,
``csrc/viterbi.cu``: one warp runs the recursion near its dependent
chain while six other warps of the block derive the back pointers from
the stored deltas and compose the backtrace's unit maps, so a decode
ends a short tail after its forward;
``viterbi_plan`` gives its layout) and a plain loop for CPU ones
(``viterbi_reference``).  In the JAX package the recursion is a
``lax.scan`` that XLA compiles, so the kernel replaces no TPU kernel; it
exists because an eager loop of three tiny ops a frame costs seconds a
decode.  Dispatch is on the tensor's device, with no fallback: a CUDA
tensor launches the kernel or raises.

``launch_counts["viterbi"]`` counts the kernel's launches (one per
launch, nothing else adds to it).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..gmm.kernels import weighted_logdens
from ..gmm.model import GmmDiag
from ..gmm.scoring import stack_gmms
from ..utils.logging import count, recording

MAX_STATES = 32                 # one warp holds a step of the recursion
launch_counts = {"viterbi": 0}

# the kernel's layout (csrc/viterbi.cu): one block of 256 threads; a ring
# of three 64-step slots of emissions; six consumer warps, each holding
# a unit of 64 rows of deltas (at a stride of SP rounded up to 4), its
# back pointers (64 x 32 bytes) and its paths (32 x 64 bytes); the 256
# threads' maps of 32 states and their top states, in bytes.  A copy for
# planning without a card: the library gives its own figure
# (lia_viterbi_shared_bytes), which the card tests hold against this one
VITERBI_THREADS = 256
RING_STEPS, RING_SLOTS = 64, 3
UNIT_ROWS = RING_STEPS          # back pointer rows of a unit
UNIT_MAP_BYTES = 32
CONSUMER_WARPS = 6
GATHER_UNITS = 16               # units a tail warp writes a step


def instance(s: int) -> int:
    """The kernel instance (SP) that decodes S states: S up to 8, else S
    rounded up to a multiple of 4 (12, 16, ..., 32)."""
    return s if s <= 8 else -(-s // 4) * 4


def shared_bytes(s: int) -> int:
    """The dynamic shared memory of S's instance, in bytes."""
    sp = instance(s)
    ds = -(-sp // 4) * 4
    return (RING_SLOTS * RING_STEPS * sp * 4
            + CONSUMER_WARPS * UNIT_ROWS * (ds * 4 + 2 * 32)
            + VITERBI_THREADS * 33)


@dataclasses.dataclass(frozen=True)
class ViterbiPlan:
    """How ``csrc/viterbi.cu`` decodes N frames of S states: the chain
    warp's ``chunks`` ring chunks of ``RING_STEPS`` steps (the last
    ``tail_steps`` long), each published to the consumers when done; its
    deltas' device scratch (``delta_floats``: N·S and 32 for the idle
    lanes); the N − 1 back pointer rows in ``units`` units of
    ``UNIT_ROWS``, whose back pointers stay in shared memory, each unit's
    path from every top state in device scratch (``table_bytes``: S·64 a
    unit), and its map and top state (``map_bytes``: 33 a unit and 16 for
    the gather's last 16-byte read); the tail's threads compose
    ``backtrace_units`` unit maps each, and its warps write at most
    ``backtrace_rows`` rows of path each, ``GATHER_UNITS`` units a step."""
    chunks: int
    tail_steps: int
    delta_floats: int
    units: int
    table_bytes: int
    map_bytes: int
    backtrace_units: int
    backtrace_rows: int


def viterbi_plan(n: int, s: int) -> ViterbiPlan:
    """The kernel's layout for N frames and S states (plain arithmetic,
    the kernel's own).  The kernel's indices are 32-bit and the largest it
    forms is (N + 127)·S (its emission ring reads up to two chunks ahead),
    so it takes (N + 128)·S + 32 < 2^31."""
    if n < 1 or not 1 <= s <= MAX_STATES or (n + 128) * s + 32 >= 2 ** 31:
        raise ValueError(f"viterbi: N = {n}, S = {s} outside N >= 1, "
                         f"1 <= S <= {MAX_STATES}, (N + 128)·S + 32 < 2^31")
    chunks = -(-n // RING_STEPS)
    rows = n - 1
    units = -(-rows // UNIT_ROWS)
    steps = -(-units // GATHER_UNITS)
    warps = VITERBI_THREADS // 32
    return ViterbiPlan(chunks, n - (chunks - 1) * RING_STEPS, n * s + 32,
                       units, units * s * UNIT_ROWS,
                       units * (UNIT_MAP_BYTES + 1) + 16,
                       -(-units // VITERBI_THREADS),
                       min(-(-steps // warps) * GATHER_UNITS * UNIT_ROWS,
                           rows))


def reset_launch_counts() -> None:
    launch_counts["viterbi"] = 0


def _log_trans(trans, device=None) -> torch.Tensor:
    return torch.log(torch.as_tensor(np.asarray(trans), dtype=torch.float32,
                                     device=device) + 1e-30)


@dataclasses.dataclass
class DiarHmm:
    """States (stacked GmmDiag with leading state axis) + names +
    log-transition matrix."""

    gmms: GmmDiag          # leading axis = state
    names: list[str]
    log_trans: torch.Tensor   # (S, S)

    @property
    def n_states(self) -> int:
        return len(self.names)

    @classmethod
    def from_gmms(cls, gmms: list[GmmDiag], names: list[str],
                  trans: np.ndarray | None = None) -> "DiarHmm":
        if trans is None:
            trans = compute_transitions(len(gmms))
        stacked = stack_gmms(gmms)
        return cls(stacked, list(names), _log_trans(trans, stacked.device))

    def replace_state(self, idx: int, gmm: GmmDiag) -> "DiarHmm":
        def put(stacked, leaf):
            out = stacked.clone()
            out[idx] = leaf
            return out
        new = GmmDiag(put(self.gmms.weights, gmm.weights),
                      put(self.gmms.means, gmm.means),
                      put(self.gmms.cov_inv, gmm.cov_inv))
        return dataclasses.replace(self, gmms=new)


def compute_transitions(n_states: int, gamma: float = 0.8) -> np.ndarray:
    """Reference computeTransitions (Tools.h:110): strong self-loop
    probability gamma, remainder spread over other states."""
    if n_states == 1:
        return np.ones((1, 1))
    off = (1.0 - gamma) / (n_states - 1)
    t = np.full((n_states, n_states), off)
    np.fill_diagonal(t, gamma)
    return t


def stacked_emission_llk(x: torch.Tensor, gmms: GmmDiag) -> torch.Tensor:
    """Per-frame log-likelihood (N, S) under each of S stacked GMMs: one
    product of the frames against all S·K components, then a logsumexp
    per state."""
    s, k, d = gmms.means.shape
    flat = GmmDiag(gmms.weights.reshape(s * k), gmms.means.reshape(s * k, d),
                   gmms.cov_inv.reshape(s * k, d))
    return torch.logsumexp(weighted_logdens(x, flat).reshape(-1, s, k),
                           dim=-1)


def emission_llk(x: torch.Tensor, hmm: DiarHmm) -> torch.Tensor:
    """Per-frame per-state GMM log-likelihood (N, S)."""
    return stacked_emission_llk(x, hmm.gmms)


def viterbi_reference(emissions: torch.Tensor,
                      log_trans: torch.Tensor) -> torch.Tensor:
    """Log-domain Viterbi over (N, S) emissions → state path (N,) int64:
    the plain loop (the CPU path, and what ``viterbi_cuda`` is held
    against).  ``delta0 = em[0] − log S``; per frame
    ``cand = delta[:, None] + log_trans``, the best previous state per
    target (the first index on a tie), ``max + em_t``; then the
    backtrace (on the host).  All f32 adds and maxima.

    The path is the JAX package's, index for index: its reverse scan
    emits the state it holds BEFORE stepping back, so ``path[t]`` is the
    best state of frame t+1 for t < N−1 and ``path[N−1]`` the last
    state (the sequence one frame early, the state of frame 0 dropped).
    The port keeps that so that both packages label every frame alike."""
    n, s = emissions.shape
    em = emissions.to(torch.float32)
    lt = log_trans.to(torch.float32)
    delta = em[0] - math.log(s)
    backs = []
    for t in range(1, n):
        best, arg = torch.max(delta[:, None] + lt, dim=0)
        backs.append(arg)
        delta = best + em[t]
    path = np.empty(n, np.int64)
    path[n - 1] = int(torch.argmax(delta))
    if backs:
        back = torch.stack(backs).cpu().numpy()
        state = path[n - 1]
        for r in range(n - 2, -1, -1):
            path[r] = state
            state = back[r, state]
    return torch.from_numpy(path).to(emissions.device)


def viterbi_cuda(emissions: torch.Tensor,
                 log_trans: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel of ``csrc/viterbi.cu``: the same path as
    ``viterbi_reference``, state for state, in one launch of one block
    (layout: ``viterbi_plan``).  emissions (N, S) and log_trans (S, S):
    contiguous f32 CUDA tensors, S ≤ 32, (N + 128)·S + 32 < 2^31.  While
    a profiler records it counts the back pointer rows
    (``lia.seg.viterbi_bp_rows``, N − 1) and those the kernel had not
    derived when its forward's last step was stored
    (``lia.seg.viterbi_tail_rows``, read back from the card)."""
    for label, t in (("emissions", emissions), ("log_trans", log_trans)):
        if t.device.type != "cuda":
            raise ValueError(f"viterbi_cuda: {label} on {t.device} has no "
                             "kernel")
        if t.dtype != torch.float32:
            raise TypeError(f"viterbi_cuda: {label} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"viterbi_cuda: {label} must be contiguous")
    if emissions.dim() != 2 or emissions.shape[0] < 1:
        raise ValueError("viterbi_cuda: emissions must be (N, S), N >= 1, "
                         f"got {tuple(emissions.shape)}")
    n, s = emissions.shape
    if not 1 <= s <= MAX_STATES:
        raise ValueError(f"viterbi_cuda: {s} states outside "
                         f"1..{MAX_STATES}")
    if (n + 128) * s + 32 >= 2 ** 31:
        raise ValueError(f"viterbi_cuda: N = {n}, S = {s}: (N + 128)·S + "
                         "32 exceeds the kernel's 32-bit indices")
    if log_trans.shape != (s, s) or log_trans.device != emissions.device:
        raise ValueError(f"viterbi_cuda: log_trans {tuple(log_trans.shape)} "
                         f"on {log_trans.device} does not fit emissions "
                         f"{tuple(emissions.shape)} on {emissions.device}")
    from .._build import library

    lib = library("viterbi")
    dev = emissions.device
    # the forward's deltas, the units' path tables, their maps and top
    # states, and the tail's count
    plan = viterbi_plan(n, s)
    deltas = torch.empty((plan.delta_floats,), dtype=torch.float32,
                         device=dev)
    table = torch.empty((max(plan.table_bytes, 1),), dtype=torch.uint8,
                        device=dev)
    maps = torch.empty((max(plan.map_bytes, 1),), dtype=torch.uint8,
                       device=dev)
    tail = torch.empty((1,), dtype=torch.int32, device=dev)
    path = torch.empty((n,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.lia_viterbi(
            emissions.data_ptr(), log_trans.data_ptr(), n, s, math.log(s),
            deltas.data_ptr(), table.data_ptr(), maps.data_ptr(),
            tail.data_ptr(), path.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"viterbi_cuda: CUDA kernel launch failed "
                           f"(cudaError {err})")
    if recording():
        count("lia.seg.viterbi_bp_rows", n - 1)
        count("lia.seg.viterbi_tail_rows", int(tail.item()))
    launch_counts["viterbi"] += 1
    return path


def _viterbi(emissions: torch.Tensor, log_trans: torch.Tensor
             ) -> torch.Tensor:
    """Viterbi path (N,) of (N, S) emissions: the kernel for a CUDA
    tensor, the plain loop for a CPU one."""
    if emissions.device.type == "cpu":
        return viterbi_reference(emissions, log_trans)
    return viterbi_cuda(emissions.contiguous(),
                        log_trans.to(emissions.device).contiguous())


def viterbi_decode(x: torch.Tensor, hmm: DiarHmm,
                   mask: torch.Tensor | None = None) -> np.ndarray:
    """Most likely state per frame (reference viterbiDecoding,
    Tools.cpp:1021).  Masked-out frames keep the previous state by giving
    them uniform emissions."""
    em = emission_llk(x, hmm)
    if mask is not None:
        em = torch.where(mask[:, None] > 0, em, torch.zeros_like(em))
    return _viterbi(em, hmm.log_trans).cpu().numpy()


def path_to_segments(path: np.ndarray, names: list[str],
                     frame_length: float = 0.01,
                     min_duration: int = 0) -> list:
    """State path → labelled segments; runs shorter than min_duration
    frames are merged into the previous run (reference minimum-duration
    rules, AcousticSegmentation.cpp:55-68)."""
    from ..io.labels import Segment
    if path.size == 0:
        return []
    segs: list[Segment] = []
    start = 0
    cur = path[0]
    runs = []
    for i in range(1, len(path)):
        if path[i] != cur:
            runs.append([start, i, cur])
            start, cur = i, path[i]
    runs.append([start, len(path), cur])
    if min_duration > 0:
        merged = []
        for r in runs:
            if merged and (r[1] - r[0]) < min_duration:
                merged[-1][1] = r[1]    # absorb the short run
            else:
                merged.append(r)
        # collapse adjacent same-state runs
        runs = []
        for r in merged:
            if runs and runs[-1][2] == r[2] and runs[-1][1] == r[0]:
                runs[-1][1] = r[1]
            else:
                runs.append(r)
    for a, b, st in runs:
        segs.append(Segment(a * frame_length, b * frame_length,
                            names[int(st)]))
    return segs
