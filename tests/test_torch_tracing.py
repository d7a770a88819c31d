"""The port's spans and counters (``lia_ral_tpu_torch.utils.logging``):
off without a profiler, written into the profiler's trace and into
``counters.json`` under ``profile_trace``, nested where the work happens,
counting what the inputs say, and leaving every result as it was.  Tiny
sizes on the CPU."""

from __future__ import annotations

import json
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.convert import bw_stats_from_numpy, gmm_from_numpy
from lia_ral_tpu_torch.fa import stats as tstats
from lia_ral_tpu_torch.fa import tv as ttv
from lia_ral_tpu_torch.gmm import em as tem
from lia_ral_tpu_torch.utils import logging as tlog
from torch.autograd import profiler

from _torch_parity import random_gmm_np

PACKAGE = Path(__file__).resolve().parent.parent / "lia_ral_tpu_torch"
LENGTHS = [5, 17, 33, 40, 9, 64, 70, 31, 2]
BUCKET, BATCH, K, D = 32, 2, 8, 3


def _entries(rng, lengths=LENGTHS):
    return [(rng.standard_normal((n, D)).astype(np.float32),
             (rng.random(n) > 0.2).astype(np.float32)) for n in lengths]


def _gmm(rng):
    return gmm_from_numpy(*random_gmm_np(rng, K, D))


def _tv_case(rng, s=10, r=4):
    gmm = _gmm(rng)
    t = (rng.standard_normal((r, K, D)) * 0.5).astype(np.float32)
    n = (rng.random((s, K)) * 50 + 0.5).astype(np.float32)
    f = (rng.standard_normal((s, K, D)) * 4).astype(np.float32)
    return bw_stats_from_numpy(n, f), ttv.TvModel.from_ubm(t, gmm)


def _trace(logdir: Path):
    """(name, start, end, thread) of every range of ``logdir/trace.json``,
    and ``counters.json``."""
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e.get("tid")) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return ranges, json.loads((logdir / "counters.json").read_text())


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _inside(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] and p[3] == child[3]
               for p in parents)


def test_without_a_profiler_spans_are_the_shared_noop_and_counters_rest(rng):
    assert not profiler._is_profiler_enabled
    assert tlog.span("lia.a") is tlog.span("lia.b")
    with tlog.span("lia.a"), tlog.span("lia.b"):
        pass
    before = dict(tlog.counters)
    tlog.count("lia.tv.blocks", 5)
    gmm = _gmm(rng)
    stats = tstats.bw_stats_bucketed(_entries(rng), gmm, bucket=BUCKET,
                                     batch_size=BATCH)
    tstats_, model = _tv_case(rng)
    ttv.estimate_w(tstats_, model, chunk=4)
    assert stats.n.shape == (len(LENGTHS), K)
    assert tlog.counters == before


def test_the_profiler_flag_exists_and_follows_the_profiler(tmp_path):
    """``span`` and ``count`` read torch's own record of a running
    profiler; a torch that renames it must fail here, not silently
    switch the program's tracing off."""
    assert profiler._is_profiler_enabled is False
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
        assert tlog.span("lia.a") is not tlog.span("lia.a")
    assert profiler._is_profiler_enabled is False
    with tlog.profile_trace(str(tmp_path / "tr")):
        assert profiler._is_profiler_enabled is True
    assert profiler._is_profiler_enabled is False


def test_bw_stats_bucketed_spans_nest_and_counters_follow_the_inputs(
        rng, tmp_path):
    entries = _entries(rng)
    gmm = _gmm(rng)
    with tlog.profile_trace(str(tmp_path / "tr")):
        tstats.bw_stats_bucketed(entries, gmm, bucket=BUCKET,
                                 batch_size=BATCH)
    ranges, counted = _trace(tmp_path / "tr")
    outer = _named(ranges, "lia.fa.bw_stats_bucketed")
    assert len(outer) == 1
    by_len: dict[int, list[int]] = {}
    for n in LENGTHS:
        by_len.setdefault(-(-n // BUCKET) * BUCKET, []).append(n)
    batches = sent = 0
    for plen, ns in by_len.items():
        for s0 in range(0, len(ns), BATCH):
            rows = len(ns[s0:s0 + BATCH])
            batches += 1
            sent += (1 << (rows - 1).bit_length()) * plen
    assert counted["lia.stats.batches"] == batches == 6
    assert counted["lia.stats.frames_sent"] == sent
    assert counted["lia.stats.frames_carried"] == sum(LENGTHS)
    # only the carried frames and mask values go over, with each batch's
    # row offsets (one int32 more than its rows)
    offsets = len(LENGTHS) + batches
    assert counted["lia.stats.h2d_bytes"] == (
        sum(LENGTHS) * (D + 1) + offsets) * 4
    assert counted["lia.stats.pinned_batches"] == 0      # the CPU: unpinned
    assert counted["lia.stats.slot_waits"] == 0
    assert counted["lia.tv.blocks"] == 0
    for name, many in (("lia.stats.pad", batches), ("lia.stats.h2d", batches),
                       ("lia.stats.batch", batches),
                       ("lia.stats.gather", batches + 1)):
        inner = _named(ranges, name)
        assert len(inner) == many, name
        assert all(_inside(r, outer) for r in inner), name


@pytest.mark.parametrize("pcg_tol,iters", [(1e-7, 6), (0.0, 5), (0.5, 8)])
def test_estimate_w_counts_its_host_reads(rng, tmp_path, monkeypatch,
                                          pcg_tol, iters):
    """``lia.tv.host_syncs`` equals the host reads the call made (every
    ``bool`` of a tensor, counted apart) and the ``lia.tv.pcg_check``
    spans; none with ``pcg_tol=0``."""
    stats, model = _tv_case(rng)
    reads = []
    inner = torch.Tensor.__bool__

    def counted_bool(t):
        reads.append(1)
        return inner(t)
    with tlog.profile_trace(str(tmp_path / "tr")):
        monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
        ttv.estimate_w(stats, model, chunk=4, pcg_iters=iters,
                       pcg_tol=pcg_tol)
        monkeypatch.undo()
    ranges, counted = _trace(tmp_path / "tr")
    blocks = 3                                   # 10 utterances, chunk 4
    assert counted["lia.tv.blocks"] == blocks
    assert len(_named(ranges, "lia.tv.block")) == blocks
    assert len(_named(ranges, "lia.tv.basis")) == 1
    assert counted["lia.tv.host_syncs"] == len(reads)
    assert counted["lia.tv.host_syncs"] == len(_named(ranges,
                                                      "lia.tv.pcg_check"))
    its = counted["lia.tv.pcg_iters"]
    if pcg_tol == 0.0:
        assert counted["lia.tv.host_syncs"] == 0
        assert its == blocks * iters
    else:
        # a block checks before each iteration it runs, and once more
        # where it stops early
        assert its <= counted["lia.tv.host_syncs"] <= its + blocks
        assert 0 < its <= blocks * iters
    outer = _named(ranges, "lia.fa.estimate_w")
    assert len(outer) == 1
    assert all(_inside(r, outer) for r in ranges if r[0].startswith("lia.tv"))


def test_train_model_writes_a_span_a_em_iteration(rng, tmp_path):
    x = torch.from_numpy(rng.standard_normal((300, D)).astype(np.float32))
    w = torch.ones(300)
    cfg = tem.TrainCfg(nb_train_it=3)
    with tlog.profile_trace(str(tmp_path / "tr")):
        tem.train_model(torch.Generator().manual_seed(0), x, w, _gmm(rng),
                        cfg)
    ranges, _ = _trace(tmp_path / "tr")
    outer = _named(ranges, "lia.gmm.train_model")
    its = _named(ranges, "lia.gmm.em_iteration")
    steps = _named(ranges, "lia.gmm.m_step")
    assert len(outer) == 1
    assert len(its) == len(steps) == cfg.nb_train_it
    assert all(_inside(r, outer) for r in its)
    assert all(_inside(r, its) for r in steps)


def test_results_are_bitwise_the_same_traced_or_not(rng, tmp_path):
    entries = _entries(rng)
    gmm = _gmm(rng)
    stats, model = _tv_case(rng)
    x = torch.from_numpy(rng.standard_normal((300, D)).astype(np.float32))
    w = torch.ones(300)
    cfg = tem.TrainCfg(nb_train_it=2, bagged_frame_probability=0.7)

    def run():
        st = tstats.bw_stats_bucketed(entries, gmm, bucket=BUCKET,
                                      batch_size=BATCH)
        iv = ttv.estimate_w(stats, model, chunk=4)
        ubm = tem.train_model(torch.Generator().manual_seed(1), x, w, gmm,
                              cfg)
        return [st.n, st.f, iv, ubm.weights, ubm.means, ubm.cov_inv]

    plain = run()
    with tlog.profile_trace(str(tmp_path / "tr")):
        traced = run()
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_every_span_and_counter_name_of_the_package_starts_with_lia():
    """Program spans and counters are told from the benchmark's
    ``bench.*`` spans by their prefix; each counted name is registered."""
    calls = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for line in path.read_text().splitlines():
            for m in re.finditer(r"(?<![\w.])(span|count)\(([^)]*)", line):
                if not re.match(r"\s*def\b", line):
                    calls.append((path.name, m.group(1), m.group(2)))
    spans = [c for c in calls if c[1] == "span"]
    assert len(spans) >= 13
    for where, kind, arg in calls:
        name = re.match(r'"([^"]+)"', arg)
        assert name, (where, kind, arg)
        assert name.group(1).startswith("lia."), (where, arg)
        if kind == "count":
            assert name.group(1) in tlog.counters, (where, arg)
    assert all(name.startswith("lia.") for name in tlog.counters)


def test_profile_trace_writes_what_its_block_counted(tmp_path):
    tlog.count("lia.tv.blocks", 7)             # no profiler: not counted
    before = dict(tlog.counters)
    with tlog.profile_trace(str(tmp_path / "tr")):
        tlog.count("lia.tv.blocks", 3)
        tlog.count("lia.stats.h2d_bytes", 1 << 33)
    _, counted = _trace(tmp_path / "tr")
    assert set(counted) == set(tlog.counters)
    assert counted["lia.tv.blocks"] == 3
    assert counted["lia.stats.h2d_bytes"] == 1 << 33
    assert sum(counted.values()) == 3 + (1 << 33)
    assert tlog.counters["lia.tv.blocks"] == before["lia.tv.blocks"] + 3
    tlog.reset_counters()
    assert set(tlog.counters.values()) == {0}


def test_counts_from_many_threads_add_up(tmp_path):
    """A mesh's shards count from threads; no update is lost."""
    threads, each = 16, 2000

    def work():
        for _ in range(each):
            tlog.count("lia.tv.pcg_iters")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tlog.profile_trace(str(tmp_path / "tr")):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    _, counted = _trace(tmp_path / "tr")
    assert counted["lia.tv.pcg_iters"] == threads * each
