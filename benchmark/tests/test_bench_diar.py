"""What the diarization cell adds beyond what every cell's tests cover:
``flops_seg``'s counts on shapes checked by hand, and its readers of the
program's ``lia.seg.*`` spans and counters, which give what the tiny
run's counters say and nothing, raising nothing, on a program without
them."""

import types

import pytest

from benchmark import core, flops, flops_seg, run

CELL = "diar_ehmm_meignier2006.bn_show_1h"
NEW = ("seg_adapt_ms_per_pass", "seg_decode_ms_per_pass",
       "seg_host_mb_per_pass")
SEED = 2**31 + 4242


def test_viterbi_counts_adds_and_comparisons_and_each_byte_once():
    # S² adds and S² comparisons a frame
    assert flops_seg.viterbi_ops(1, 1) == 2
    assert flops_seg.viterbi_ops(10, 3) == 2 * 10 * 9
    # emissions in (N·S f32), the path out (N int64), transitions (S² f32)
    assert flops_seg.viterbi_bytes(10, 3) == 4 * 30 + 8 * 10 + 4 * 9


def test_emission_block_counts_each_pair_as_k1_counts_its_logits():
    assert flops_seg.emission_flops(1, 1, 1, 1) == 6
    assert flops_seg.emission_flops(300_000, 24, 128, 20) == pytest.approx(
        300_000 * 24 * 128 * 82)
    # K1's logits of n frames against K components are the same products
    assert flops_seg.emission_flops(7, 1, 5, 3) * 2 == flops.k1_flops(7, 5, 3)


def test_viterbi_at_the_cell_is_bound_by_bytes():
    n, s = 300_000, 24
    t, by = flops.least_seconds(flops_seg.viterbi_ops(n, s),
                                flops_seg.viterbi_bytes(n, s))
    assert by == "bytes"
    assert t == pytest.approx((4 * n * s + 8 * n + 4 * s * s) / 3.35e12)


def _profiled(tmp_path):
    from lia_ral_tpu_torch.utils import logging as program_log

    _, cfg, traffic, drv = run.load_cell(CELL, tiny=True)
    ctx = run.context(CELL, cfg, traffic, SEED, "cpu", str(tmp_path))
    st = drv.setup(ctx)
    program_log.reset_counters()
    prof = core.Recorder(ctx.device, annotate=True)
    sub, tr = core.profile(lambda: drv.profiled(st, prof), ctx.device,
                           str(tmp_path), prof)
    win = core.Window(values={}, attempted=1, failed=0, elapsed=1.0,
                      extra={"profiled": sub})
    drv.release(st)
    return cfg, traffic, types.SimpleNamespace(
        window=win, trace=tr, prof=prof, cell=CELL,
        rec=core.Recorder(ctx.device))


def test_readers_follow_the_programs_spans_and_counters(tmp_path):
    from lia_ral_tpu_torch.utils import logging as program_log

    cfg, traffic, rctx = _profiled(tmp_path)
    c = program_log.counters
    n = traffic["frames"]
    assert c["lia.seg.viterbi_frames"] == n * c["lia.seg.decodes"]
    s = cfg["max_speakers"]
    assert c["lia.seg.decodes"] >= 2 + (s - 1) * (
        cfg["segmentation"]["nb_decode_it"] + 1)
    mb = run.metric_reader("seg_host_mb_per_pass").read(rctx)
    assert mb == pytest.approx(
        (c["lia.seg.h2d_bytes"] + c["lia.seg.d2h_bytes"]) / 1e6)
    for name in ("seg_adapt_ms_per_pass", "seg_decode_ms_per_pass"):
        assert run.metric_reader(name).read(rctx) > 0
    # no device operation on the CPU: no kernel time to share a roofline
    assert run.metric_reader("viterbi_roofline_pct").read(rctx) is None


def test_readers_give_none_without_the_programs_spans_and_counters(
        tmp_path, monkeypatch):
    from lia_ral_tpu_torch.utils import logging as program_log

    _, _, rctx = _profiled(tmp_path)
    rctx.trace.annotations = [a for a in rctx.trace.annotations
                              if not a[0].startswith("lia.")]
    monkeypatch.setattr(program_log, "counters",
                        {k: v for k, v in program_log.counters.items()
                         if not k.startswith("lia.seg.")})
    for name in NEW:
        assert run.metric_reader(name).read(rctx) is None, name


def test_trace_index_gives_the_harness_device_time():
    """On a trace with ranges on two threads and operations inside,
    between and outside them, the sorted index sums what the harness's
    scan sums."""
    import random

    rnd = random.Random(5)
    anns, ops, launches = [], [], {}
    for tid in (1, 2):
        t = 0.0
        for _ in range(40):
            t += rnd.uniform(1, 5)
            dur = rnd.uniform(1, 8)
            anns.append(("bench.k1" if rnd.random() < 0.7 else "other", t,
                         dur, tid))
            t += dur
    for corr in range(600):
        lts = rnd.uniform(0, 500)
        launches[corr] = (lts, rnd.choice((1, 2)))
        ops.append(("op", lts + 1, rnd.uniform(0.1, 2), corr))
    ops.append(("copy", 3.0, 1.0, None))
    tr = core.Trace(ops, launches, anns, 0.0, 600.0)
    from benchmark import trace_index

    want = tr.span_device_seconds("bench.k1")
    assert want and trace_index.span_device_seconds(tr, "bench.k1") == \
        pytest.approx(want, rel=1e-12)
    assert trace_index.span_device_seconds(tr, "absent") is None
