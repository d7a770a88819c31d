"""The spans and counters of the port's E-HMM segmentation and
ReSegmentation (``seg.diarization``; ``utils.logging``): under a profiler
each counter equals its closed form in the run's shapes, the spans nest
where the work happens; with no profiler every counter stays 0 and the
paths are the same.  Small sizes on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from lia_ral_tpu_torch.gmm.model import GmmDiag
from lia_ral_tpu_torch.seg import diarization as tdz
from lia_ral_tpu_torch.utils import logging as tlog
from torch.autograd import profiler

import _torch_parity  # noqa: F401  (two torch threads a test worker)

K, D, N = 8, 4, 1500
S, NB_DECODE, NB_RESEG = 3, 2, 2
SEG = [name for name in tlog.counters if name.startswith("lia.seg.")]


def _case(rng):
    w = rng.random(K) + 0.5
    world = GmmDiag(torch.from_numpy((w / w.sum()).astype(np.float32)),
                    torch.from_numpy(rng.standard_normal((K, D))
                                     .astype(np.float32)),
                    torch.from_numpy((1.0 / (rng.random((K, D)) + 0.5))
                                     .astype(np.float32)))
    centre = np.repeat(rng.standard_normal((5, D)) * 2.0, N // 5, axis=0)
    x = (centre + rng.standard_normal((N, D))).astype(np.float32)
    return x, world


def _run(x, world):
    segs, path = tdz.e_hmm_segmentation(
        x, world, max_speakers=S, init_seg_frames=200,
        nb_decode_it=NB_DECODE, min_duration=20)
    _, rpath = tdz.resegmentation(x, segs, world, nb_it=NB_RESEG,
                                  min_duration=20, min_state_frames=10)
    return segs, path, rpath


def _ranges(logdir: Path):
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] and p[3] == child[3]
               for p in parents)


def test_without_a_profiler_every_seg_counter_stays_zero(rng):
    assert not profiler._is_profiler_enabled and not tlog.recording()
    before = dict(tlog.counters)
    x, world = _case(rng)
    _run(x, world)
    assert tlog.counters == before


def test_counters_equal_their_closed_forms_and_spans_nest(
        rng, tmp_path, monkeypatch):
    x, world = _case(rng)
    _, plain_path, plain_rpath = _run(x, world)
    empty, rows = [], []
    inner = tdz._batched_state_adapt

    def counting(generator, xt, masks, w, **kw):
        empty.append(int((masks.sum(1) == 0).sum()))
        rows.append((masks != 0).sum(1).tolist())
        return inner(generator, xt, masks, w, **kw)

    monkeypatch.setattr(tdz, "_batched_state_adapt", counting)
    with tlog.profile_trace(str(tmp_path / "tr")):
        segs, path, rpath = _run(x, world)
    counted = json.loads((tmp_path / "tr" / "counters.json").read_text())
    np.testing.assert_array_equal(path, plain_path)
    np.testing.assert_array_equal(rpath, plain_rpath)

    s_r = len({sg.label for sg in segs})
    decodes_e = 2 + (S - 1) * (NB_DECODE + 1)
    decodes_r = NB_RESEG + 1
    adapts_e = 1 + (S - 1) * (1 + NB_DECODE)
    adapts_r = 1 + NB_RESEG
    assert counted["lia.seg.decodes"] == decodes_e + decodes_r
    assert counted["lia.seg.viterbi_frames"] == N * (decodes_e + decodes_r)
    assert counted["lia.seg.state_adapts"] == S * adapts_e + s_r * adapts_r
    assert len(empty) == adapts_e + adapts_r
    # the E-HMM's first adaptation and each seed adapt one row alone
    assert empty[0] == S - 1 and counted["lia.seg.empty_adapts"] == sum(empty)
    # one grouped stats pass a MAP iteration of each adaptation with a
    # frame, over the rows' own frames, each row from a multiple of 256
    nb_it, unit = 3, 256
    assert all(sum(r) for r in rows)
    assert counted["lia.seg.grouped_launches"] == nb_it * len(rows)
    assert counted["lia.seg.grouped_frames"] == nb_it * sum(map(sum, rows))
    assert counted["lia.seg.grouped_pad_frames"] == nb_it * sum(
        -c % unit for r in rows for c in r)
    assert counted["lia.seg.h2d_bytes"] == 4 * (
        2 * N * D                                          # the frames, twice
        + (S * adapts_e + s_r * adapts_r) * N              # (S, N) masks
        + decodes_e * (S * S + S) + decodes_r * (s_r * s_r + s_r))
    assert counted["lia.seg.d2h_bytes"] == (
        (decodes_e + decodes_r) * N * 8                    # int64 paths
        + decodes_e * N * S * 4)                           # E-HMM emissions
    # the Viterbi kernel's two counts: no kernel runs on the CPU
    assert counted["lia.seg.viterbi_bp_rows"] == 0
    assert counted["lia.seg.viterbi_tail_rows"] == 0
    assert {k: v for k, v in counted.items() if k.startswith("lia.seg.")
            and v == 0} == {"lia.seg.viterbi_bp_rows": 0,
                            "lia.seg.viterbi_tail_rows": 0}

    ranges = _ranges(tmp_path / "tr")

    def named(name):
        return [r for r in ranges if r[0] == name]
    assert len(named("lia.seg.e_hmm")) == len(named("lia.seg.reseg")) == 1
    calls = named("lia.seg.e_hmm") + named("lia.seg.reseg")
    decodes, adapts = named("lia.seg.decode"), named("lia.seg.adapt")
    assert len(decodes) == decodes_e + decodes_r
    assert len(adapts) == adapts_e + adapts_r
    assert all(_inside(r, calls) for r in decodes + adapts)
    for child in ("lia.seg.emissions", "lia.seg.viterbi", "lia.seg.d2h"):
        assert len(named(child)) == len(decodes)
        assert all(_inside(r, decodes) for r in named(child))
    assert len(named("lia.seg.masks")) == len(adapts)
    assert all(_inside(r, adapts) for r in named("lia.seg.masks"))


def test_every_seg_counter_is_listed():
    assert set(SEG) == {"lia.seg.decodes", "lia.seg.viterbi_frames",
                        "lia.seg.viterbi_bp_rows",
                        "lia.seg.viterbi_tail_rows",
                        "lia.seg.state_adapts", "lia.seg.empty_adapts",
                        "lia.seg.grouped_launches", "lia.seg.grouped_frames",
                        "lia.seg.grouped_pad_frames",
                        "lia.seg.h2d_bytes", "lia.seg.d2h_bytes"}
