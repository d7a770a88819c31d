"""K1's share of its roofline in the diarization cell: what
``k1_roofline_pct.py`` reads (the least time of the pass's
``em_stats_fused`` calls, each from its frames of non-zero weight, over
the device time of every operation launched under the harness's span
around each call), with the device time found by ``trace_index``: the
harness's scan takes minutes at ~7,000 calls a pass."""

from benchmark import trace_index


def read(ctx):
    return trace_index.roofline_pct(ctx, "bench.k1")
