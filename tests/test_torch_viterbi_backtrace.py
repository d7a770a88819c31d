"""The algorithms of the Viterbi kernel (``csrc/viterbi.cu``) on the CPU:
its back pointers recomputed from the forward's deltas, its backtrace by
composing chunk maps, its maximum-then-index step, and the layout the
wrapper describes (``seg.hmm.viterbi_plan``).

The kernel runs only on the card (``tests/test_torch_cuda_kernels.py``);
here each algorithm is written in numpy or torch and held against the
plain loop ``seg.hmm.viterbi_reference`` (the JAX ``_viterbi``, path
index for index), exactly.
"""

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.seg import hmm

STATES = [1, 2, 3, 5, 8, 9, 16, 17, 32]


def _forward(em, lt, with_deltas=False):
    """The plain loop's forward pass: back pointers (N-1, S) and the last
    state, as ``viterbi_reference`` computes them (and the deltas (N, S)
    of every step)."""
    n, s = em.shape
    delta = em[0] - np.log(s)
    backs, deltas = [], [delta]
    for t in range(1, n):
        best, arg = torch.max(delta[:, None] + lt, dim=0)
        backs.append(arg)
        delta = best + em[t]
        deltas.append(delta)
    back = (torch.stack(backs).numpy() if backs
            else np.zeros((0, s), np.int64))
    if with_deltas:
        return back, int(torch.argmax(delta)), torch.stack(deltas).numpy()
    return back, int(torch.argmax(delta))


def _back_pointers_from_deltas(deltas, lt):
    """The kernel's back-pointer pass: row r, state k: the smallest i
    with the largest deltas[r, i] + lt[i, k] (f32 adds, as the forward's
    own)."""
    c = deltas[:-1, :, None] + lt.numpy()[None]       # (N-1, i, k)
    return np.argmax(c, axis=1)


def _backtrace_by_maps(back, last, chunks=hmm.VITERBI_THREADS):
    """The kernel's backtrace: the N-1 rows in ``chunks`` contiguous
    chunks; each chunk's map from its top state to its bottom state for
    every state (S independent walks); the maps composed from ``last``;
    then each chunk's path written from its top state."""
    rows, s = back.shape
    length = -(-rows // chunks) if rows else 0
    bounds = [(min(c * length, rows), min(c * length + length, rows))
              for c in range(chunks)]
    maps = np.empty((chunks, s), np.int64)
    for c, (lo, hi) in enumerate(bounds):
        cur = np.arange(s)
        for r in range(hi - 1, lo - 1, -1):
            cur = back[r, cur]
        maps[c] = cur
    tops = np.empty(chunks, np.int64)
    state = last
    for c in range(chunks - 1, -1, -1):
        tops[c] = state
        state = maps[c, state]
    path = np.empty(rows + 1, np.int64)
    path[rows] = last
    for c, (lo, hi) in enumerate(bounds):
        state = tops[c]
        for r in range(hi - 1, lo - 1, -1):
            path[r] = state
            state = back[r, state]
    return path


def _sequential(back, last):
    path = np.empty(back.shape[0] + 1, np.int64)
    path[-1] = state = last
    for r in range(back.shape[0] - 1, -1, -1):
        path[r] = state
        state = back[r, state]
    return path


def _tied_problem(n, s, seed):
    """Emissions on a coarse grid and uniform transitions: many ties."""
    rng = np.random.default_rng(seed)
    em = torch.from_numpy(rng.integers(-2, 3, (n, s)).astype(np.float32))
    lt = torch.log(torch.full((s, s), 1.0 / s))
    return em, lt


@pytest.mark.parametrize("s", STATES)
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257])
def test_map_backtrace_equals_the_plain_loop(n, s):
    em, lt = _tied_problem(n, s, seed=n * 100 + s)
    back, last = _forward(em, lt)
    want = hmm.viterbi_reference(em, lt).numpy()
    np.testing.assert_array_equal(_backtrace_by_maps(back, last), want)


@pytest.mark.parametrize("s", STATES)
@pytest.mark.parametrize("n", [2, 257, 3000])
def test_back_pointers_from_the_deltas_are_the_forwards(n, s):
    """Back pointers recomputed from the stored deltas (the kernel's pass
    after the forward) equal the ones the forward's torch.max chose, ties
    included, and the map backtrace on them gives the plain loop's path."""
    em, lt = _tied_problem(n, s, seed=n + s)
    back, last, deltas = _forward(em, lt, with_deltas=True)
    again = _back_pointers_from_deltas(deltas, lt)
    np.testing.assert_array_equal(again, back)
    np.testing.assert_array_equal(_backtrace_by_maps(again, last),
                                  hmm.viterbi_reference(em, lt).numpy())


@pytest.mark.parametrize("s", [5, 32])
def test_map_backtrace_at_the_diarization_length(s):
    rng = np.random.default_rng(s)
    em = torch.from_numpy((rng.standard_normal((30573, s)) * 3)
                          .astype(np.float32))
    lt = torch.log(torch.from_numpy(hmm.compute_transitions(s)
                                    .astype(np.float32)) + 1e-30)
    back, last = _forward(em, lt)
    want = hmm.viterbi_reference(em, lt).numpy()
    np.testing.assert_array_equal(_backtrace_by_maps(back, last), want)


@pytest.mark.parametrize("chunks", [1, 7, 256])
@pytest.mark.parametrize("n,s", [(2, 1), (300, 3), (1000, 17), (5000, 32)])
def test_map_backtrace_on_random_back_pointers(n, s, chunks):
    rng = np.random.default_rng(n + s)
    back = rng.integers(0, s, (n - 1, s))
    last = int(rng.integers(s))
    np.testing.assert_array_equal(_backtrace_by_maps(back, last, chunks),
                                  _sequential(back, last))


def _best_previous(c, s):
    """The kernel's step on one lane's candidates c (S real, -inf up to
    SP): the maximum by a pairwise fmaxf tree, then the smallest index
    whose candidate equals it."""
    sp = s if s <= 8 else (16 if s <= 16 else 32)
    c = np.concatenate([c, np.full(sp - s, -np.inf, np.float32)])
    m = c.copy()
    w = 1
    while w < sp:
        for i in range(0, sp - w, 2 * w):
            m[i] = max(m[i], m[i + w])
        w *= 2
    a = sp - 1
    for i in range(sp - 2, -1, -1):
        a = i if c[i] == m[0] else a
    return m[0], a


@pytest.mark.parametrize("s", STATES)
def test_step_maximum_and_index_are_torch_max(s):
    rng = np.random.default_rng(s)
    for _ in range(200):
        c = rng.integers(-3, 3, s).astype(np.float32)
        best, arg = torch.max(torch.from_numpy(c), dim=0)
        assert _best_previous(c, s) == (float(best), int(arg))


@pytest.mark.parametrize("n,chunks,tail", [(1, 1, 1), (64, 1, 64),
                                           (65, 2, 1), (128, 2, 64),
                                           (129, 3, 1)])
def test_plan_ring_chunks(n, chunks, tail):
    plan = hmm.viterbi_plan(n, 5)
    assert (plan.chunks, plan.tail_steps) == (chunks, tail)
    assert plan.delta_floats == n * 5 + 32


@pytest.mark.parametrize("n,rows", [(1, 0), (2, 1), (257, 1), (258, 2),
                                    (30573, 120)])
def test_plan_backtrace_rows(n, rows):
    assert hmm.viterbi_plan(n, 5).backtrace_rows == rows


@pytest.mark.parametrize("s", [5, 32])
def test_plan_back_pointers_switch_to_device_memory(s):
    full = hmm.BP_SHARED_BYTES // s + 1       # (N-1)·S fits exactly or not
    at = hmm.viterbi_plan(full, s)
    assert at.shared_bp_bytes == (full - 1) * s and at.device_bp_bytes == 0
    over = hmm.viterbi_plan(full + 1, s)
    assert over.shared_bp_bytes == hmm.BP_SHARED_BYTES
    assert over.device_bp_bytes == full * s - hmm.BP_SHARED_BYTES > 0


def test_plan_fits_the_diarization_in_shared_memory():
    plan = hmm.viterbi_plan(30573, 5)
    assert plan.device_bp_bytes == 0 and plan.shared_bp_bytes == 152_860
    assert hmm.BP_SHARED_BYTES == 198_400


def test_plan_rejects_what_the_kernel_cannot_index():
    with pytest.raises(ValueError):
        hmm.viterbi_plan(2 ** 26, 32)
    with pytest.raises(ValueError):
        hmm.viterbi_plan(10, 33)
    with pytest.raises(ValueError):
        hmm.viterbi_plan(0, 5)


@pytest.mark.parametrize("s", [1, 5, 32])
def test_plan_takes_the_largest_n_the_kernel_indexes(s):
    """The kernel's largest 32-bit index is (N + 127)·S, the ring's source
    two chunks past the end: the plan takes the last N with (N + 128)·S +
    32 < 2^31 and refuses the next."""
    n = (2 ** 31 - 33) // s - 128
    assert (n + 128) * s + 32 < 2 ** 31 <= (n + 129) * s + 32
    assert hmm.viterbi_plan(n, s).delta_floats == n * s + 32
    with pytest.raises(ValueError):
        hmm.viterbi_plan(n + 1, s)
