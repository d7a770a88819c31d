"""The diarization's batched state adaptation on grouped statistics
(``seg.diarization._batched_state_adapt``): each row's frames of non-zero
mask gathered once, one grouped stats pass a MAP iteration over them
(K1's grouped entry on the card, ``em.grouped_stats_fn``), and the M-step
and MAP update of every row at once.

On the CPU it is held against the per-row loop it replaced (one
``adapt_model`` a mask row, kept here) within float32 rounding, and its
MAP update (``m_step`` and ``map_adapt`` over a leading row axis)
against the same functions a row at a time, digit for digit.  The tests
marked ``cuda`` hold the grouped K1 against the wrapper's plain version
of each row (``em_stats_reference`` on CPU copies) and against per-row
``em_stats_fused`` on the card, and skip elsewhere."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.gmm import cuda_kernels as ck
from lia_ral_tpu_torch.gmm import em as tem
from lia_ral_tpu_torch.gmm.kernels import EmStats
from lia_ral_tpu_torch.gmm.map_adapt import MapCfg, adapt_model, map_adapt
from lia_ral_tpu_torch.gmm.model import GmmDiag
from lia_ral_tpu_torch.gmm.scoring import stack_gmms
from lia_ral_tpu_torch.seg import diarization as tdz

from _torch_parity import cuda_device, np_of  # noqa: F401

K, D, N, S = 16, 6, 2400, 24
REG, NB_IT = 16.0, 3


@pytest.fixture
def rng():
    return np.random.default_rng(20261018)


def _world(rng, k=K, d=D, device="cpu"):
    w = rng.random(k) + 0.3
    return GmmDiag(
        torch.tensor(w / w.sum(), dtype=torch.float32, device=device),
        torch.tensor(rng.standard_normal((k, d)), dtype=torch.float32,
                     device=device),
        torch.tensor(1.0 / (rng.random((k, d)) + 0.5), dtype=torch.float32,
                     device=device))


def _frames(rng, n=N, d=D, device="cpu"):
    centre = np.repeat(rng.standard_normal((8, d)) * 1.5, -(-n // 8),
                       axis=0)[:n]
    return torch.tensor(centre + rng.standard_normal((n, d)),
                        dtype=torch.float32, device=device)


def _masks(rng, case, s=S, n=N):
    m = np.zeros((s, n), np.float32)
    if case == "partition":         # the decode's masks: a label a frame
        m[rng.integers(0, s - 4, n), np.arange(n)] = 1.0
    elif case == "overlap":         # rows sharing frames
        for r in range(s):
            a = rng.integers(0, n - 400)
            m[r, a:a + rng.integers(1, 400)] = 1.0
        m[1] = m[0]
    elif case == "fractional":      # weights other than 0/1
        m[:] = rng.random((s, n)) * (rng.random((s, n)) < 0.1)
    elif case == "seed":            # the E-HMM's seed: one row of 300
        m[5, 700:1000] = 1.0
    return torch.from_numpy(m)


def _per_row(x, masks, world):
    """The loop the grouped path replaced: one ``adapt_model`` a row."""
    cfg = MapCfg(method="MAPOccDep", mean_adapt=True, weight_adapt=True,
                 mean_r=REG, weight_r=REG, nb_train_it=NB_IT)
    return stack_gmms([adapt_model(torch.Generator(), x, m, world, cfg)
                       for m in masks])


@pytest.mark.parametrize("case", ["partition", "overlap", "fractional",
                                  "seed", "empty"])
def test_grouped_adapt_matches_the_per_row_loop(rng, case):
    """Every case of masks against one ``adapt_model`` a row: float32
    sums over the same frames in another order, carried through three
    MAP iterations (weights within 1e-6, means within 1e-5 of their
    scale); a row with no frame is the loop's world digit for digit."""
    world = _world(rng)
    x = _frames(rng)
    masks = _masks(rng, case)
    got = tdz._batched_state_adapt(torch.Generator(), x, masks, world,
                                   map_reg=REG, nb_it=NB_IT)
    want = _per_row(x, masks, world)
    np.testing.assert_allclose(np_of(got.weights), np_of(want.weights),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np_of(got.means), np_of(want.means), rtol=0,
                               atol=1e-5 * float(want.means.abs().max()))
    assert torch.equal(got.cov_inv, want.cov_inv)
    empty = ~(masks != 0).any(1)
    assert torch.equal(got.weights[empty], want.weights[empty])
    assert torch.equal(got.means[empty], want.means[empty])
    assert torch.equal(got.means[empty],
                       world.means.expand(int(empty.sum()), K, D))
    if case == "empty":
        assert bool(empty.all())


def test_batched_map_update_equals_the_per_row_functions(rng):
    """``m_step`` and ``map_adapt``'s MAPOccDep update on stats with a
    leading row axis give what they give a row at a time on the same
    stats, digit for digit, empty rows included."""
    world = _world(rng)
    n = torch.tensor(rng.random((S, K)) * 50, dtype=torch.float32)
    n[3] = 0.0
    n[7, :5] = 0.0
    sx = torch.tensor(rng.standard_normal((S, K, D)), dtype=torch.float32)
    sxx = torch.tensor(rng.random((S, K, D)) * 40, dtype=torch.float32)
    st = EmStats(n=n, sum_x=sx * n[..., None], sum_xx=sxx,
                 llk=torch.zeros(S), count=n.sum(1))
    cfg = MapCfg(method="MAPOccDep", mean_adapt=True, weight_adapt=True,
                 mean_r=REG, weight_r=REG)
    em_rows = tem.m_step(st)
    got = map_adapt(world, em_rows, st.count, cfg)
    assert got.weights.shape == (S, K) and got.means.shape == (S, K, D)
    assert torch.equal(got.cov_inv, world.cov_inv)
    for r in range(S):
        row = EmStats(n=n[r], sum_x=st.sum_x[r], sum_xx=sxx[r],
                      llk=st.llk[r], count=st.count[r])
        em_row = tem.m_step(row)
        for f in ("weights", "means", "cov_inv"):
            assert torch.equal(getattr(em_rows, f)[r], getattr(em_row, f))
        want = map_adapt(world, em_row, row.count, cfg)
        assert torch.equal(got.weights[r], want.weights)
        assert torch.equal(got.means[r], want.means)


def test_the_cpu_grouped_pass_is_the_f32_path_of_each_row(rng, monkeypatch):
    """On the CPU each MAP iteration runs ``em_stats_chunked`` once a row
    on that row's own frames, padding left out: ``nb_it`` × S calls whose
    frames of non-zero weight add up to ``nb_it`` × the masks' count."""
    world = _world(rng)
    x = _frames(rng)
    masks = _masks(rng, "fractional")
    calls = []
    inner = tem.em_stats_chunked

    def counting(xc, wc, gmm, chunk=4096):
        calls.append((xc.shape[0], int(torch.count_nonzero(wc))))
        return inner(xc, wc, gmm, chunk=chunk)

    monkeypatch.setattr(tem, "em_stats_chunked", counting)
    tdz._batched_state_adapt(torch.Generator(), x, masks, world,
                             map_reg=REG, nb_it=NB_IT)
    per_row = (masks != 0).sum(1).tolist()
    assert [c[0] for c in calls] == per_row * NB_IT
    assert sum(c[1] for c in calls) == NB_IT * int((masks != 0).sum())


def test_grouped_layout_aligns_rows_and_cuts_chunks_inside_them():
    """``group_rows`` puts each row from a multiple of 256 frames;
    ``group_table`` cuts each non-empty row into chunks of at most
    ``chunk_len`` frames inside it and maps every 256 frames to its row."""
    counts = [0, 300, 1, 0, 5000, 256, 0]
    g = ck.group_rows(counts, 128, "cpu")
    assert g.counts == tuple(counts) and g.table is None
    padded = [-(-c // 256) * 256 for c in counts]
    assert g.starts == tuple(np.cumsum([0] + padded[:-1]))
    assert g.n_frames == sum(padded)
    assert g.pad_frames == sum(padded) - sum(counts)
    chunk_len, n_chunks, table = ck.group_table(padded, 128)
    assert chunk_len % 256 == 0
    start = table[:n_chunks + 1]
    row = table[n_chunks + 1:2 * n_chunks + 1]
    row_chunks = table[2 * n_chunks + 1:2 * n_chunks + 1 + len(counts) + 1]
    unit_row = table[2 * n_chunks + 2 + len(counts):]
    assert start[0] == 0 and start[-1] == g.n_frames
    assert (np.diff(start) > 0).all() and (np.diff(start) <= chunk_len).all()
    assert (start % 256 == 0).all()
    for r, (a, p) in enumerate(zip(g.starts, padded)):
        mine = np.arange(row_chunks[r], row_chunks[r + 1])
        assert (row[mine] == r).all()
        if p:
            assert start[mine[0]] == a and start[mine[-1] + 1] == a + p
        else:
            assert mine.size == 0
    assert (unit_row == np.repeat(np.arange(len(counts)),
                                  np.asarray(padded) // 256)).all()


def test_grouped_k1_wrapper_on_the_cpu_and_its_modes(rng):
    """``em_stats_fused`` with groups on CPU tensors: the plain version of
    each row's own frames; another arithmetic than the default tier, or
    a chunk, raises."""
    bank = stack_gmms([_world(rng) for _ in range(3)])
    g = ck.group_rows([40, 0, 300], K, "cpu")
    x = torch.zeros((g.n_frames, D))
    w = torch.zeros(g.n_frames)
    for a, c in zip(g.starts, g.counts):
        x[a:a + c] = _frames(rng, c)
        w[a:a + c] = 1.0
    got = ck.em_stats_fused(x, w, bank, groups=g)
    for r, (a, c) in enumerate(zip(g.starts, g.counts)):
        want = ck.em_stats_reference(x[a:a + c], w[a:a + c], GmmDiag(
            bank.weights[r], bank.means[r], bank.cov_inv[r]))
        assert torch.equal(got.n[r], want.n)
        assert torch.equal(got.sum_x[r], want.sum_x)
        assert torch.equal(got.llk[r], want.llk)
    assert float(got.count[1]) == 0.0
    for kw in ({"stats_pass": "bf16nx"}, {"compute_dtype": torch.bfloat16},
               {"exp_mode": "exp"}, {"chunk": 256}):
        with pytest.raises(ValueError):
            ck.em_stats_fused(x, w, bank, groups=g, **kw)
    with pytest.raises(ValueError):
        ck.em_stats_fused(x[:-256], w[:-256], bank, groups=g)


# -- on the card ---------------------------------------------------------------

def _rows_case(rng, counts, k, d, frac, device):
    bank = stack_gmms([_world(rng, k, d, device) for _ in counts])
    g = ck.group_rows(counts, k, device)
    x = torch.zeros((g.n_frames, d), device=device)
    w = torch.zeros(g.n_frames, device=device)
    for a, c in zip(g.starts, g.counts):
        x[a:a + c] = _frames(rng, c, d, device)
        w[a:a + c] = (torch.rand(c, device=device) if frac
                      else torch.ones(c, device=device))
    return bank, g, x, w


@pytest.mark.cuda
@pytest.mark.parametrize("counts,k,d,frac", [
    ([12000, 0, 9000, 300, 1, 0, 14000], 128, 20, False),
    ([0] * 5 + [300] + [0] * 18, 128, 20, False),
    ([3000, 0, 256, 257], 200, 39, True),
    ([20000, 7000, 0], 2048, 60, False),
    ([1000, 513, 0, 2], 37, 6, True)])
def test_grouped_k1_matches_per_row_k1(cuda_device, rng, counts, k, d, frac):
    """Each row of one grouped launch against the wrapper's plain version
    (its CPU branch: ``em_stats_reference`` on that row's frames, from
    CPU copies) and against ``em_stats_fused`` on that row's frames
    alone, within the kernel tests' budgets (n rtol 1e-4, sums 1e-3, of
    the array's max; llk 1e-5, count 1e-6 relative); a second call equal
    to the digit; an empty row exact zeros."""
    bank, g, x, w = _rows_case(rng, counts, k, d, frac, cuda_device)
    before = ck.launch_counts["em_stats_fused_grouped"]
    got = ck.em_stats_fused(x, w, bank, groups=g)
    again = ck.em_stats_fused(x, w, bank, groups=g)
    assert ck.launch_counts["em_stats_fused_grouped"] == before + 2
    for f in ("n", "sum_x", "sum_xx", "llk", "count"):
        assert torch.equal(getattr(got, f), getattr(again, f))
    plain = ck.em_stats_fused(x.cpu(), w.cpu(), bank.to("cpu"),
                              groups=ck.group_rows(counts, k, "cpu"))
    assert ck.launch_counts["em_stats_fused_grouped"] == before + 2
    for r, (a, c) in enumerate(zip(g.starts, g.counts)):
        if c == 0:
            for f in ("n", "sum_x", "sum_xx", "llk", "count"):
                assert bool((getattr(got, f)[r] == 0).all())
            continue
        one = ck.em_stats_fused(
            x[a:a + c].contiguous(), w[a:a + c].contiguous(),
            GmmDiag(bank.weights[r], bank.means[r], bank.cov_inv[r]))
        for ref in (EmStats(*(t[r] for t in dataclasses.astuple(plain))),
                    one):
            for f, tol in (("n", 1e-4), ("sum_x", 1e-3), ("sum_xx", 1e-3)):
                want = getattr(ref, f)
                np.testing.assert_allclose(
                    np_of(getattr(got, f)[r]), np_of(want), rtol=tol,
                    atol=tol * float(want.abs().max()))
            assert (abs(float(got.llk[r]) - float(ref.llk))
                    <= 1e-5 * abs(float(ref.llk)))
            assert (abs(float(got.count[r]) - float(ref.count))
                    <= 1e-6 * float(ref.count))


@pytest.mark.cuda
def test_grouped_adapt_on_cuda_launches_once_an_iteration(cuda_device, rng,
                                                          monkeypatch):
    """On the card one adaptation calls ``em.em_stats_fused`` ``nb_it``
    times, once a MAP iteration, with the frames of non-zero weight of
    all rows (the harness charges each call that count), and launches
    nothing where no row has a frame; the bank matches the per-row loop
    on the card."""
    world = _world(rng, 128, 20, cuda_device)
    x = _frames(rng, 6000, 20, cuda_device)
    masks = _masks(rng, "partition", 24, 6000).to(cuda_device)
    calls = []
    inner = tem.em_stats_fused

    def counting(xc, wc, gmm, **kw):
        calls.append(int(torch.count_nonzero(wc)))
        return inner(xc, wc, gmm, **kw)

    monkeypatch.setattr(tem, "em_stats_fused", counting)
    got = tdz._batched_state_adapt(torch.Generator(device=cuda_device), x,
                                   masks, world, map_reg=REG, nb_it=NB_IT)
    assert len(calls) == NB_IT
    assert sum(calls) == NB_IT * int((masks != 0).sum())
    monkeypatch.undo()
    want = _per_row(x, masks, world)
    np.testing.assert_allclose(np_of(got.means), np_of(want.means), rtol=0,
                               atol=1e-4 * float(want.means.abs().max()))
    np.testing.assert_allclose(np_of(got.weights), np_of(want.weights),
                               rtol=0, atol=1e-5)
    before = dict(ck.launch_counts)
    empty = tdz._batched_state_adapt(
        torch.Generator(device=cuda_device), x, torch.zeros_like(masks),
        world, map_reg=REG, nb_it=NB_IT)
    assert ck.launch_counts == before
    assert torch.equal(empty.means, world.means.expand(24, 128, 20))
