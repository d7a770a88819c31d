"""What the GMM-SVM cell adds beyond what every cell's tests cover:
``flops_svm``'s counts on shapes checked by hand, and its readers of the
program's ``lia.svm.*`` spans and counters, which give what the tiny
run's counters say and nothing, raising nothing, on a program without
them."""

import types

import pytest

from benchmark import core, flops, flops_svm, run

CELL = "gmm_svm_nap_campbell2006.enrol_1conv"
NEW = ("svm_dual_roofline_pct", "svm_train_ms_per_pass",
       "svm_host_mb_per_pass")
SEED = 2**31 + 777


def test_dual_counts_products_with_q_and_bisections():
    # 17 + steps products of 2·N², steps + 1 bisections of 3·N·50
    assert flops_svm.dual_ops(1, 0) == 2 * 17 + 150
    assert flops_svm.dual_ops(10, 500) == 2 * 100 * 517 + 3 * 10 * 50 * 501
    # K in once, y and C in, α out
    assert flops_svm.dual_bytes(10) == 4 * (100 + 30)


def test_summed_forms_equal_the_sum_over_solves():
    solves = [(55, 500), (4096, 500), (1001, 300)]
    q = sum(n * n for n, _ in solves)
    sq = sum(s * n * n for n, s in solves)
    v = sum(n for n, _ in solves)
    sv = sum(s * n for n, s in solves)
    assert flops_svm.dual_ops_summed(q, sq, v, sv) == pytest.approx(
        sum(flops_svm.dual_ops(n, s) for n, s in solves), rel=1e-15)
    assert flops_svm.dual_bytes_summed(q, v) == sum(
        flops_svm.dual_bytes(n) for n, _ in solves)


def test_the_rest_of_a_pass():
    assert flops_svm.gram_flops(4096, 77_824) == 2 * 4096 ** 2 * 77_824
    assert flops_svm.nap_flops(77_824, 64) == 4 * 77_824 * 64
    assert flops_svm.decision_flops(250, 77_824) == 2 * 250 * 77_824


def test_the_solve_at_the_cell_is_bound_by_bytes():
    n = 4096
    t, by = flops.least_seconds(flops_svm.dual_ops(n, 500),
                                flops_svm.dual_bytes(n))
    assert by == "bytes"
    assert t == pytest.approx(4 * (n * n + 3 * n) / 3.35e12)


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
    n_t = traffic["targets"]
    n = 1 + traffic["background_speakers"] * traffic["background_sessions"]
    assert c["lia.svm.solves"] == n_t
    assert c["lia.svm.vectors"] == n_t * n
    assert c["lia.svm.q_entries"] == n_t * n * n
    assert c["lia.svm.dual_steps"] == 500 * n_t * n * n
    mb = run.metric_reader("svm_host_mb_per_pass").read(rctx)
    assert mb == pytest.approx(
        (c["lia.svm.h2d_bytes"] + c["lia.svm.d2h_bytes"]) / 1e6)
    width = cfg["n_components"] * cfg["feature_dim"]
    assert c["lia.svm.d2h_bytes"] >= n_t * 4 * n * width
    assert run.metric_reader("svm_train_ms_per_pass").read(rctx) > 0
    # no device operation on the CPU: no kernel time to share a roofline
    assert run.metric_reader("svm_dual_roofline_pct").read(rctx) is None


def test_readers_give_none_without_the_programs_spans_and_counters(
        tmp_path, monkeypatch):
    from lia_ral_tpu_torch.utils import logging as program_log

    _, _, rctx = _profiled(tmp_path)
    rctx.trace.annotations = [a for a in rctx.trace.annotations
                              if not a[0].startswith("lia.")]
    monkeypatch.setattr(program_log, "counters",
                        {k: v for k, v in program_log.counters.items()
                         if not k.startswith("lia.svm.")})
    for name in NEW:
        assert run.metric_reader(name).read(rctx) is None, name
