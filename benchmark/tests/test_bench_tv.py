"""What the TV-training cell adds beyond what every cell's tests cover:
``flops_tv``'s counts on shapes checked by hand, and its readers of the
program's ``lia.tv.*`` training spans, which give what the tiny run's
spans say and nothing, raising nothing, on a program without them."""

import types

import pytest

from benchmark import core, flops_tv, run

CELL = "ivec_dehak2011.tv_train"
NEW = ("tv_e_step_ms_per_pass", "tv_m_step_ms_per_pass",
       "tv_e_step_idle_ms_per_pass")
SEED = 2**31 + 2222


def test_session_counts_l_a_aux_c_and_the_factorisation():
    # 4·K·R² (L and A) + 4·K·D·R (T Σ⁻¹ F̄ and C) + R³ (Cholesky, L⁻¹)
    assert flops_tv.session_flops(1, 1, 1) == 4 + 4 + 1
    assert flops_tv.session_flops(3, 2, 5) == 4 * 75 + 4 * 30 + 125


def test_pass_counts_e_c_the_m_step_and_min_divergence():
    k, d, r = 3, 2, 6
    e_c = 2 * k * r * r * d
    m_step = k * (2 * r ** 3 / 3 + 2 * r * r * d)
    min_div = 2 * r * r * k * d + r ** 3 / 3
    assert flops_tv.pass_fixed_flops(k, d, r) == pytest.approx(
        e_c + m_step + min_div, rel=1e-15)
    assert flops_tv.pass_flops(10, k, d, r) == pytest.approx(
        10 * flops_tv.session_flops(k, d, r) + e_c + m_step + min_div,
        rel=1e-15)


def test_a_pass_at_the_cell():
    wl, cfg, t, _ = run.load_cell(CELL)
    k, d, r = cfg["n_components"], cfg["feature_dim"], cfg["tv_rank"]
    assert (k, d, r) == (2048, 60, 400)
    assert (t["sessions"], t["tool"]["speakerChunk"]) == (16384, 64)
    assert flops_tv.pass_flops(t["sessions"], k, d, r) == pytest.approx(
        2.596e13, rel=1e-3)


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
    return traffic, types.SimpleNamespace(
        window=win, trace=tr, prof=prof, cell=CELL,
        rec=core.Recorder(ctx.device))


def test_readers_follow_the_programs_spans_and_counters(tmp_path):
    from lia_ral_tpu_torch.utils import logging as program_log

    traffic, rctx = _profiled(tmp_path)
    c = program_log.counters
    s, chunk = traffic["sessions"], traffic["tool"]["speakerChunk"]
    assert c["lia.tv.e_sessions"] == s
    assert c["lia.tv.e_chunks"] == -(-s // chunk)
    assert c["lia.tv.e_pad_sessions"] == chunk * c["lia.tv.e_chunks"] - s
    lengths = {n: sum(dur for name, _, dur, _ in rctx.trace.annotations
                      if name == n) * 1e-3
               for n in ("lia.tv.e_step", "lia.tv.m_step", "lia.tv.min_div")}
    assert run.metric_reader("tv_e_step_ms_per_pass").read(rctx) \
        == pytest.approx(lengths["lia.tv.e_step"])
    assert run.metric_reader("tv_m_step_ms_per_pass").read(rctx) \
        == pytest.approx(lengths["lia.tv.m_step"] + lengths["lia.tv.min_div"])
    # no device operation on the CPU: the whole E-step is idle time
    assert run.metric_reader("tv_e_step_idle_ms_per_pass").read(rctx) \
        == pytest.approx(lengths["lia.tv.e_step"])


def test_readers_give_none_without_the_programs_spans(tmp_path):
    _, rctx = _profiled(tmp_path)
    rctx.trace.annotations = [a for a in rctx.trace.annotations
                              if not a[0].startswith("lia.")]
    for name in NEW:
        assert run.metric_reader(name).read(rctx) is None, name


def test_judge_holds_the_first_draws_statistics_to_their_posteriors(
        tmp_path):
    """The tiny cell's K2 statistics of its first draw are within the
    limits of their float64 posteriors; moved by 1 %, they fail."""
    wl, cfg, traffic, drv = run.load_cell(CELL, tiny=True)
    st = drv.setup(run.context(CELL, cfg, traffic, SEED, "cpu",
                               str(tmp_path)))
    drv.release(st)
    b = traffic["tool"]["speakerChunk"]
    assert st["got_stats"][0].shape[0] == b
    limits = wl["limits"]
    sound = {n: v for n, v, _ in drv.judge(st, limits)}
    n, f = st["got_stats"]
    st["got_stats"] = (n * 1.01, f * 1.01)
    moved = {n: v for n, v, _ in drv.judge(st, limits)}
    for name in ("occupancy_gap", "first_order_gap"):
        assert sound[name] <= limits[name] < moved[name], name
