"""Host-clock milliseconds of ``estimate_w`` in a pass (the harness's
span, ending in a synchronise), averaged over the window's passes."""

from benchmark import core


def read(ctx):
    return core.span_ms(ctx, "bench.estimate_w")
