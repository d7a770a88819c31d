"""The algorithms of the Viterbi kernel (``csrc/viterbi.cu``) on the CPU:
its back pointers recomputed from the forward's deltas a published
64-step chunk at a time, each unit's path from every top state and its
map, the tail's composition from the last state and its gather, its
maximum-then-index step, and the layout the wrapper describes
(``seg.hmm.viterbi_plan``).

The kernel runs only on the card (``tests/test_torch_cuda_kernels.py``);
here each algorithm is written in numpy or torch and held against the
plain loop ``seg.hmm.viterbi_reference`` (the JAX ``_viterbi``, path
index for index), exactly.
"""

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.seg import hmm

STATES = [1, 2, 3, 5, 8, 9, 12, 16, 17, 20, 24, 28, 32]


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
    """The kernel's consumers: row r, state k: the smallest i with the
    largest deltas[r, i] + lt[i, k] (f32 adds, as the forward's own),
    derived a published chunk of ``RING_STEPS`` rows at a time."""
    rows = deltas.shape[0] - 1
    back = np.empty((rows, deltas.shape[1]), np.int64)
    for lo in range(0, rows, hmm.RING_STEPS):
        hi = min(lo + hmm.RING_STEPS, rows)
        c = deltas[lo:hi, :, None] + lt.numpy()[None]   # (rows, i, k)
        back[lo:hi] = np.argmax(c, axis=1)
    return back


def _unit_tables(back):
    """Each unit of ``UNIT_ROWS`` rows walked down from every top state s
    (what lane s of a consumer warp does): the unit's path for each top
    state, (units, S, UNIT_ROWS), and at the bottom its map, (units, S)."""
    rows, s = back.shape
    units = -(-rows // hmm.UNIT_ROWS)
    table = np.zeros((units, s, hmm.UNIT_ROWS), np.int64)
    maps = np.empty((units, s), np.int64)
    for u in range(units):
        lo, hi = u * hmm.UNIT_ROWS, min(u * hmm.UNIT_ROWS + hmm.UNIT_ROWS,
                                        rows)
        st = np.arange(s)
        for r in range(hi - 1, lo - 1, -1):
            table[u, :, r - lo] = st
            st = back[r, st]
        maps[u] = st
    return table, maps


def _backtrace_by_maps(back, last, threads=hmm.VITERBI_THREADS):
    """The kernel's tail: thread t composes the maps of its contiguous
    ceil(units / threads) units; the composites composed from ``last``
    give each thread's top state; each thread walks its units' maps for
    each unit's top state; then path[r] = table[unit, top, r % 64]."""
    rows, s = back.shape
    table, maps = _unit_tables(back)
    units = maps.shape[0]
    per = -(-units // threads) if units else 0
    owners = -(-units // per) if per else 0
    composite = np.empty((owners, s), np.int64)
    for t in range(owners):
        cur = np.arange(s)
        for u in range(min(t * per + per, units) - 1, t * per - 1, -1):
            cur = maps[u, cur]
        composite[t] = cur
    tops = np.empty(owners, np.int64)
    state = last
    for t in range(owners - 1, -1, -1):
        tops[t] = state
        state = composite[t, state]
    utops = np.empty(units, np.int64)
    for t in range(owners):
        state = tops[t]
        for u in range(min(t * per + per, units) - 1, t * per - 1, -1):
            utops[u] = state
            state = maps[u, state]
    path = np.empty(rows + 1, np.int64)
    path[rows] = last
    r = np.arange(rows)
    path[:rows] = table[r // hmm.UNIT_ROWS, utops[r // hmm.UNIT_ROWS],
                        r % hmm.UNIT_ROWS]
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
    """The tail with ``chunks`` threads composing the unit maps."""
    rng = np.random.default_rng(n + s)
    back = rng.integers(0, s, (n - 1, s))
    last = int(rng.integers(s))
    np.testing.assert_array_equal(_backtrace_by_maps(back, last, chunks),
                                  _sequential(back, last))


def _e_hmm_problem(n, s, active, seed):
    """The E-HMM's decode: emissions of ``active`` states, the rest
    −1e30, transitions among the active states and log 1e-30 elsewhere."""
    rng = np.random.default_rng(seed)
    em = (rng.standard_normal((n, s)) * 3).astype(np.float32)
    em[:, active:] = -1e30
    t = np.full((s, s), 1e-30)
    t[:active, :active] = hmm.compute_transitions(active)
    return (torch.from_numpy(em),
            torch.log(torch.from_numpy(t.astype(np.float32))))


def _schedule(em, lt):
    """The kernel's whole schedule: the forward's deltas, back pointers a
    published chunk at a time, the unit tables and maps, the tail."""
    back, last, deltas = _forward(em, lt, with_deltas=True)
    again = _back_pointers_from_deltas(deltas, lt)
    np.testing.assert_array_equal(again, back)
    return _backtrace_by_maps(again, last)


# the edges of the 64-row units and published chunks (N - 1 rows: 62, 63,
# 64, 65; 127, 128) and of the tail's 256 threads (256 units: one each;
# 257: two each)
@pytest.mark.parametrize("s", [1, 5, 24, 32])
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 66, 128, 129,
                               256 * 64 + 1, 256 * 64 + 2])
def test_schedule_equals_the_plain_loop_at_the_chunk_edges(n, s):
    em, lt = _tied_problem(n, s, seed=7 * n + s)
    np.testing.assert_array_equal(_schedule(em, lt),
                                  hmm.viterbi_reference(em, lt).numpy())


def test_schedule_at_the_diarization_cell_shape():
    """300,000 frames of 24 states, 13 active and 11 at −1e30, as the
    E-HMM decodes them mid-way: the schedule's path is the plain loop's
    and never enters an inactive state."""
    em, lt = _e_hmm_problem(300_000, 24, 13, seed=24)
    got = _schedule(em, lt)
    assert got.max() < 13
    np.testing.assert_array_equal(got, hmm.viterbi_reference(em, lt).numpy())


@pytest.mark.parametrize("s", [1, 5, 24])
def test_schedule_on_log_densities(s):
    """Emissions as log densities (all negative, the E-HMM's −1e30
    columns among them) and log-probability transitions: the schedule's
    path is the plain loop's."""
    em, lt = _e_hmm_problem(3000, s, max(1, s // 2), seed=s)
    em = em - em.max() - 1.0
    np.testing.assert_array_equal(_schedule(em, lt),
                                  hmm.viterbi_reference(em, lt).numpy())


def _best_previous(c, s):
    """The kernel's step on one lane's candidates c (S real, -inf up to
    SP): the maximum by a pairwise fmaxf tree, then the smallest index
    whose candidate equals it."""
    sp = hmm.instance(s)
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


@pytest.mark.parametrize("n,units,per,rows", [
    (1, 0, 0, 0), (2, 1, 1, 1), (257, 4, 1, 256), (258, 5, 1, 257),
    (30573, 478, 2, 4096), (256 * 64 + 2, 257, 2, 3 * 16 * 64),
    (300_000, 4688, 19, 37 * 16 * 64)])
def test_plan_backtrace_rows(n, units, per, rows):
    """N − 1 rows in units of 64; a tail thread composes ceil(units /
    256) unit maps; a tail warp writes 16 units of path a step."""
    plan = hmm.viterbi_plan(n, 5)
    assert (plan.units, plan.backtrace_units, plan.backtrace_rows) == (
        units, per, rows)


@pytest.mark.parametrize("s", [5, 32])
def test_plan_back_pointers_switch_to_device_memory(s):
    """The back pointers stay in shared memory, a unit at a time, at any
    N: where the layout before switched them to device memory (its
    198,400 shared bytes full, and one row more) device memory takes each
    unit's path from every top state (S·64 bytes) and its map and top
    state (33), and the shared memory does not grow."""
    full = 198_400 // s + 1
    for n in (full, full + 1):
        plan = hmm.viterbi_plan(n, s)
        units = -(-(n - 1) // 64)
        assert plan.units == units
        assert plan.table_bytes == units * s * 64 >= (n - 1) * s
        assert plan.map_bytes == units * 33 + 16
    assert hmm.shared_bytes(s) == {5: 49_152, 32: 106_752}[s]


def test_plan_fits_the_diarization_in_shared_memory():
    """Every instance's shared memory fits one block with room for the
    static arrays, and the diarization's decode is 478 units."""
    plan = hmm.viterbi_plan(30573, 5)
    assert plan.units == 478 and plan.table_bytes == 152_960
    assert max(hmm.shared_bytes(s) for s in range(1, 33)) == 106_752
    assert 106_752 <= 232_448 - 1024


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
