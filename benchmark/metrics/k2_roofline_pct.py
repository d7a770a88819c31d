"""K2's share of its roofline: the least time of the ``bw_stats_fused``
calls over the device time of every operation launched under the
harness's span around each call."""

from benchmark import core


def read(ctx):
    return core.roofline_pct(ctx, "bench.k2")
