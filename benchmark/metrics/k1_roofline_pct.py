"""K1's share of its roofline: the least time of the window's
``em_stats_fused`` calls (the larger of their flops over 989 TFLOP/s and
their bytes over 3.35 TB/s) over the device time of every operation
launched under the harness's span around each call."""

from benchmark import core


def read(ctx):
    return core.roofline_pct(ctx, "bench.k1")
