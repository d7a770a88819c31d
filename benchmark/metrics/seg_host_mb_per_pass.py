"""Megabytes (10^6 B) a pass that the E-HMM and ReSegmentation move
between host and card: the program's ``lia.seg.h2d_bytes`` (frames,
masks, transitions) and ``lia.seg.d2h_bytes`` (paths, E-HMM emissions)
counters in the profiled sub-window, over its passes."""

from benchmark import program


def read(ctx):
    h2d = program.counter("lia.seg.h2d_bytes")
    d2h = program.counter("lia.seg.d2h_bytes")
    n = program.passes(ctx)
    if h2d is None or d2h is None or not n or not h2d + d2h:
        return None
    return (h2d + d2h) / 1e6 / n
