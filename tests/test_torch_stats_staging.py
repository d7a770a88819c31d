"""How ``fa.stats.bw_stats_bucketed`` gets a batch's frames to the GMM's
device: packed back to back on the host into one of two staging slots,
copied once, and padded on the device.  The padded batch each
``bw_stats_batch`` call receives must be bitwise the zero-filled host
array the function built before it packed (written out here as
``_host_padded``), in the same order.  On a card the staging is
page-locked and the stats equal the CPU path's within K2's budgets.

This file imports neither jax nor the JAX package, so its CUDA case
also runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_stats_staging.py
"""

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.convert import gmm_from_numpy
from lia_ral_tpu_torch.fa import stats as tstats
from lia_ral_tpu_torch.utils import logging as tlog

from _torch_parity import cuda_device, np_of, random_gmm_np

K, D = 6, 5


def _entries(seed, lengths, dtype=np.float32):
    """Frames and masks of these lengths; masks hold zeros, ones and
    weights between them."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        m = rng.random(n)
        m[m < 0.3] = 0.0
        m[m > 0.8] = 1.0
        out.append((rng.standard_normal((n, D)).astype(dtype),
                    m.astype(dtype)))
    return out


def _host_padded(entries, bucket, batch_size):
    """The padded batches, in call order, as the host built them before
    packing: np.zeros of (next_pow2(rows), plen, D) and (.., plen), each
    row's frames and mask filled in."""
    by_len: dict[int, list[int]] = {}
    for i, (x, _) in enumerate(entries):
        by_len.setdefault(-(-max(x.shape[0], 1) // bucket) * bucket,
                          []).append(i)
    out = []
    for plen, idxs in by_len.items():
        for s0 in range(0, len(idxs), batch_size):
            grp = idxs[s0:s0 + batch_size]
            b_pad = 1 << (len(grp) - 1).bit_length()
            xs = np.zeros((b_pad, plen, D), np.float32)
            ms = np.zeros((b_pad, plen), np.float32)
            for j, i in enumerate(grp):
                x, m = entries[i]
                xs[j, :x.shape[0]] = x
                ms[j, :m.shape[0]] = m
            out.append((grp, xs, ms))
    return out


def _capture(monkeypatch):
    """Record what each ``bw_stats_batch`` call receives (on the host),
    and answer with rows that name their call and row: n[j] = 1000·call
    + j."""
    seen = []

    def spy(x, mask, gmm, **kw):
        seen.append((x.cpu().clone(), mask.cpu().clone()))
        s = x.shape[0]
        n = (1000.0 * (len(seen) - 1) + torch.arange(s, dtype=torch.float32,
                                                     device=x.device))
        return tstats.BwStats(n=n[:, None].expand(s, K).contiguous(),
                              f=torch.zeros((s, K, D), device=x.device))
    monkeypatch.setattr(tstats, "bw_stats_batch", spy)
    return seen


def _gmm(device="cpu"):
    return gmm_from_numpy(*random_gmm_np(np.random.default_rng(3), K, D),
                          device=device)


def _bits(a):
    return a.contiguous().view(torch.int32)


def _assert_batches_are_the_host_padded_ones(seen, want, entries, out):
    assert len(seen) == len(want)
    for call, ((x, m), (grp, xs, ms)) in enumerate(zip(seen, want)):
        assert x.dtype == m.dtype == torch.float32
        assert x.shape == xs.shape and m.shape == ms.shape
        assert torch.equal(_bits(x), _bits(torch.from_numpy(xs))), call
        assert torch.equal(_bits(m), _bits(torch.from_numpy(ms))), call
        for j, i in enumerate(grp):
            assert float(out.n[i, 0]) == 1000.0 * call + j, (call, j, i)
    assert out.n.shape == (len(entries), K)


@pytest.mark.parametrize("lengths,bucket,batch_size,dtype", [
    # two buckets, interleaved; 4 + 2 batches against 2 slots, the last
    # of each bucket rounded up from 3 rows to 4 and from 1 row to 1
    ([5, 17, 16, 33, 1, 40, 12, 31, 18, 7, 20, 3], 16, 3, np.float32),
    # three buckets and a frameless utterance; float64 input is cast as
    # the host arrays cast it
    ([0, 9, 70, 33, 64, 2, 65, 100, 31], 32, 2, np.float64),
    # one batch, one slot
    ([12, 3, 7], 2048, 64, np.float32),
    # one row a batch: every batch is its own power of two
    ([4, 8, 15, 16, 23, 42], 8, 1, np.float32),
])
def test_each_batch_is_bitwise_the_host_padded_one(monkeypatch, lengths,
                                                   bucket, batch_size,
                                                   dtype):
    entries = _entries(len(lengths), lengths, dtype)
    seen = _capture(monkeypatch)
    out = tstats.bw_stats_bucketed(entries, _gmm(), bucket=bucket,
                                   batch_size=batch_size)
    _assert_batches_are_the_host_padded_ones(
        seen, _host_padded(entries, bucket, batch_size), entries, out)


def test_frames_and_mask_of_different_lengths_are_refused():
    x = np.zeros((10, D), np.float32)
    with pytest.raises(ValueError, match="mask"):
        tstats.bw_stats_bucketed([(x, np.ones(9, np.float32))], _gmm())


def test_the_stats_equal_those_of_the_host_padded_batches():
    """Through the real ``bw_stats_batch``: the same numbers, to the bit,
    as the stats of the host-padded batches (the CPU's plain version)."""
    lengths, bucket, batch_size = [5, 17, 16, 33, 1, 40, 12, 31], 16, 3
    entries = _entries(11, lengths)
    gmm = _gmm()
    out = tstats.bw_stats_bucketed(entries, gmm, bucket=bucket,
                                   batch_size=batch_size)
    for grp, xs, ms in _host_padded(entries, bucket, batch_size):
        st = tstats.bw_stats_batch(torch.from_numpy(xs),
                                   torch.from_numpy(ms), gmm)
        for j, i in enumerate(grp):
            assert torch.equal(out.n[i], st.n[j])
            assert torch.equal(out.f[i], st.f[j])


def _close(got, want, rtol):
    got, want = np_of(got), np_of(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.mark.cuda
def test_cuda_staging_is_pinned_and_the_stats_equal_the_cpu_path(
        cuda_device, monkeypatch, tmp_path):
    """On the card: every batch leaves page-locked memory; the padded
    batches K2 receives are bitwise the host-padded ones, however far the
    host runs ahead of the copies; and K2's stats equal the CPU path's
    within the budgets of tests/test_torch_cuda_kernels.py (n 1e-4,
    sums 1e-3, atol scaled by the array's max)."""
    lengths = [int(n) for n in
               np.random.default_rng(1).integers(200, 2001, size=150)]
    lengths += [0, 2048, 2049]
    bucket, batch_size = 512, 8
    entries = _entries(13, lengths)
    gmm = _gmm()
    want = tstats.bw_stats_bucketed(entries, gmm, bucket=bucket,
                                    batch_size=batch_size)
    gmm_cuda = _gmm(cuda_device)
    with tlog.profile_trace(str(tmp_path / "tr")):
        before = dict(tlog.counters)
        got = tstats.bw_stats_bucketed(entries, gmm_cuda, bucket=bucket,
                                       batch_size=batch_size)
        torch.cuda.synchronize()
        counted = {k: v - before[k] for k, v in tlog.counters.items()}
    padded = _host_padded(entries, bucket, batch_size)
    assert counted["lia.stats.batches"] == len(padded) > 2
    assert counted["lia.stats.pinned_batches"] == counted["lia.stats.batches"]
    assert got.n.device.type == "cuda"
    _close(got.n, want.n, 1e-4)
    _close(got.f, want.f, 1e-3)
    seen = _capture(monkeypatch)
    out = tstats.bw_stats_bucketed(entries, gmm_cuda, bucket=bucket,
                                   batch_size=batch_size)
    _assert_batches_are_the_host_padded_ones(seen, padded, entries, out)
