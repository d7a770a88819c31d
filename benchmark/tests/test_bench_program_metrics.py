"""The readers of the program's own spans and counters: at the tiny CPU
size each counter reader gives what the tiny lengths say; each returns
None, and raises nothing, where the program has no such span or counter;
on a card the program's kernel and copy spans hold device time, the
kernel's as much as the harness's span around the same call."""

import types

import pytest

from benchmark import core, run

CELL = "ivec_dehak2011.extract_short"
NEW = ("bw_pad_ms_per_pass", "bw_h2d_gb_per_s", "bw_pad_waste_pct",
       "estimate_w_syncs_per_pass", "estimate_w_idle_ms_per_pass")
SEED = 2**31 + 777


def _profiled(cell, device, tmp_path):
    """(cell state, traffic, reader context) of one profiled sub-window
    of ``cell`` at its tiny size, with the program's counters at zero
    before it."""
    from lia_ral_tpu_torch.utils import logging as program_log

    _, cfg, traffic, drv = run.load_cell(cell, tiny=True)
    ctx = run.context(cell, cfg, traffic, SEED, device, str(tmp_path))
    st = drv.setup(ctx)
    program_log.reset_counters()
    prof = core.Recorder(ctx.device, annotate=True)
    sub, tr = core.profile(lambda: drv.profiled(st, prof), ctx.device,
                           str(tmp_path), prof)
    win = core.Window(values={}, attempted=1, failed=0, elapsed=1.0,
                      extra={"profiled": sub})
    rctx = types.SimpleNamespace(window=win, trace=tr, prof=prof, cell=cell,
                                 rec=core.Recorder(ctx.device))
    return st, traffic, rctx


def _read(name, rctx):
    return run.metric_reader(name).read(rctx)


def test_the_new_metrics_are_listed_for_the_extraction_cell():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, per = run.cell_metrics(bench, CELL)
    listed = {m["name"]: m for m in per}
    for name in NEW:
        assert listed[name]["moves"] == "audio_s_per_s.extract"
        assert listed[name]["layer"] == "library"
        assert run.metric_reader(name).read


def test_counter_readers_give_what_the_tiny_lengths_say(tmp_path):
    from lia_ral_tpu_torch.utils import logging as program_log

    st, traffic, rctx = _profiled(CELL, "cpu", tmp_path)
    tool = traffic["tool"]
    bucket, batch = tool["statsBucketFrames"], tool["statsBatchSize"]
    passes = rctx.window.extra["profiled"]["passes"]
    by_len: dict = {}
    for n in st["lengths"]:
        by_len.setdefault(-(-n // bucket) * bucket, []).append(n)
    sent = sum((1 << (len(ns[s:s + batch]) - 1).bit_length()) * plen
               for plen, ns in by_len.items()
               for s in range(0, len(ns), batch))
    carried = sum(st["lengths"])
    counted = program_log.counters
    assert counted["lia.stats.frames_sent"] == passes * sent
    assert counted["lia.stats.frames_carried"] == passes * carried
    assert counted["lia.stats.h2d_bytes"] == passes * sent * (st["d"] + 1) * 4
    assert _read("bw_pad_waste_pct", rctx) == pytest.approx(
        100.0 * (sent - carried) / sent, rel=1e-12)
    blocks = -(-len(st["lengths"]) // tool["speakerChunk"])
    assert counted["lia.tv.blocks"] == passes * blocks
    syncs = _read("estimate_w_syncs_per_pass", rctx)
    assert syncs == counted["lia.tv.host_syncs"] / passes
    assert 1 <= syncs <= blocks * tool["ivSolverPcgIterations"]
    assert _read("bw_pad_ms_per_pass", rctx) > 0
    # no device operation on the CPU: no copy rate, and the whole call idle
    assert _read("bw_h2d_gb_per_s", rctx) is None
    whole = sum(d for n, _, d, _ in rctx.trace.annotations
                if n == "lia.fa.estimate_w") * 1e-3 / passes
    assert _read("estimate_w_idle_ms_per_pass", rctx) == pytest.approx(whole)


def test_readers_give_none_without_the_programs_spans_and_counters(
        tmp_path, monkeypatch):
    """What a version of the port without them (the parent of these
    metrics) gives: nothing, and no error."""
    from lia_ral_tpu_torch.utils import logging as program_log

    _, _, rctx = _profiled(CELL, "cpu", tmp_path)
    rctx.trace.annotations = [a for a in rctx.trace.annotations
                              if not a[0].startswith("lia.")]
    monkeypatch.delattr(program_log, "counters")
    for name in NEW:
        assert _read(name, rctx) is None, name


@pytest.mark.parametrize("cell", [CELL, "ivec_dehak2011.ubm_em"])
def test_span_report_splits_the_idle_time_among_the_spans(cell, tmp_path):
    from benchmark import span_report

    line = span_report.report(cell, SEED, str(tmp_path), "cpu", tiny=True)
    by = line["idle_s_by_innermost_lia_span_per_pass"]
    assert sum(by.values()) == pytest.approx(line["idle_s_per_pass"])
    spans = ({"lia.fa.bw_stats_bucketed", "lia.stats.pad",
              "lia.fa.estimate_w", "lia.tv.pcg_check"} if cell == CELL
             else {"lia.gmm.train_model", "lia.gmm.em_iteration"})
    assert spans <= set(by)
    assert 0 < line["idle_share_nested_pct"] <= 100
    assert set(line["counters_per_pass"]) >= {"lia.stats.h2d_bytes",
                                              "lia.tv.host_syncs"}


@pytest.mark.cuda
def test_program_spans_hold_device_time_on_the_card(card, tmp_path):
    _, _, rctx = _profiled(CELL, card, tmp_path)
    tr = rctx.trace
    k2 = tr.span_device_seconds("lia.gmm.bw_stats_fused")
    assert k2 is not None and tr.span_device_seconds("lia.stats.h2d")
    assert k2 == pytest.approx(tr.span_device_seconds("bench.k2"), rel=0.01)
    for name in NEW:
        assert _read(name, rctx) is not None, name
    _, _, rctx = _profiled("ivec_dehak2011.ubm_em", card, tmp_path)
    tr = rctx.trace
    k1 = tr.span_device_seconds("lia.gmm.em_stats_fused")
    assert k1 == pytest.approx(tr.span_device_seconds("bench.k1"), rel=0.01)
