"""The spans and counters of the port's T-matrix training (``fa.tv``;
``utils.logging``): under a profiler ``lia.tv.em_iteration`` holds
``lia.tv.e_step`` (which holds one ``lia.tv.e_chunk`` a chunk),
``lia.tv.m_step`` and ``lia.tv.min_div``, and for S sessions in chunks
of c the counters read ``e_chunks`` = ⌈S/c⌉, ``e_sessions`` = S and
``e_pad_sessions`` = c⌈S/c⌉ − S; with no profiler every span is the
shared no-op and every counter stays 0, and the results are the same.
Small sizes on the CPU."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.fa import tv as ttv
from lia_ral_tpu_torch.fa.stats import BwStats
from lia_ral_tpu_torch.utils import logging as tlog
from torch.autograd import profiler

import _torch_parity  # noqa: F401  (two torch threads a test worker)

K, D, R = 8, 4, 3
TRAINING = ("lia.tv.e_chunks", "lia.tv.e_sessions", "lia.tv.e_pad_sessions")


def _problem(s, seed=2):
    rng = np.random.default_rng(seed)
    var = rng.random((K, D)).astype(np.float32) + 0.5
    n = (rng.random((s, K)) * 20).astype(np.float32)
    f = (rng.standard_normal((s, K, D)) * n[..., None]).astype(np.float32)
    t = (rng.standard_normal((R, K, D)) * 0.3).astype(np.float32)
    model = ttv.TvModel(t=torch.from_numpy(t),
                        ubm_means=torch.zeros(K, D),
                        ubm_inv_var=torch.from_numpy(1.0 / var))
    return BwStats(n=torch.from_numpy(n), f=torch.from_numpy(f)), model


def _ranges(logdir: Path):
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] and p[3] == child[3]
               for p in parents)


@pytest.mark.parametrize("s,chunk", [(70, 16), (64, 16), (5, 8), (1, 1)])
def test_counters_take_their_closed_forms_and_spans_nest(tmp_path, s,
                                                         chunk):
    stats, model = _problem(s)
    plain, w_plain = ttv.tv_em_iteration(stats, model, chunk=chunk)
    with tlog.profile_trace(str(tmp_path / "tr")):
        traced, w_traced = ttv.tv_em_iteration(stats, model, chunk=chunk)
    assert torch.equal(plain.t, traced.t)
    assert torch.equal(plain.ubm_means, traced.ubm_means)
    assert torch.equal(w_plain, w_traced)
    counted = json.loads((tmp_path / "tr" / "counters.json").read_text())
    chunks = math.ceil(s / chunk)
    assert counted["lia.tv.e_chunks"] == chunks
    assert counted["lia.tv.e_sessions"] == s
    assert counted["lia.tv.e_pad_sessions"] == chunk * chunks - s
    # extraction's counters do not move in training
    for name in ("lia.tv.blocks", "lia.tv.pcg_iters", "lia.tv.host_syncs"):
        assert counted[name] == 0, name

    ranges = _ranges(tmp_path / "tr")

    def named(name):
        return [r for r in ranges if r[0] == name]
    its = named("lia.tv.em_iteration")
    assert len(its) == 1
    for child in ("lia.tv.e_step", "lia.tv.m_step", "lia.tv.min_div"):
        assert len(named(child)) == 1, child
        assert _inside(named(child)[0], its), child
    e_step = named("lia.tv.e_step")
    assert len(named("lia.tv.e_chunk")) == chunks
    assert all(_inside(r, e_step) for r in named("lia.tv.e_chunk"))
    assert not _inside(named("lia.tv.m_step")[0], e_step)
    assert not _inside(named("lia.tv.min_div")[0], e_step)
    m_step, min_div = named("lia.tv.m_step")[0], named("lia.tv.min_div")[0]
    assert e_step[0][2] <= m_step[1] and m_step[2] <= min_div[1]


def test_without_min_divergence_no_min_div_span(tmp_path):
    stats, model = _problem(10)
    with tlog.profile_trace(str(tmp_path / "tr")):
        ttv.tv_em_iteration(stats, model, chunk=4, min_div=False)
    names = [r[0] for r in _ranges(tmp_path / "tr")]
    assert names.count("lia.tv.m_step") == 1
    assert "lia.tv.min_div" not in names


def test_without_a_profiler_spans_and_counters_stay_silent():
    assert not profiler._is_profiler_enabled and not tlog.recording()
    assert tlog.span("lia.tv.e_step") is tlog.span("lia.tv.e_chunk")
    before = dict(tlog.counters)
    stats, model = _problem(20)
    ttv.tv_em_iteration(stats, model, chunk=8)
    assert tlog.counters == before


def test_every_tv_training_counter_is_listed():
    listed = {name for name in tlog.counters if name.startswith("lia.tv.")}
    assert listed == {"lia.tv.blocks", "lia.tv.pcg_iters",
                      "lia.tv.host_syncs", *TRAINING}
