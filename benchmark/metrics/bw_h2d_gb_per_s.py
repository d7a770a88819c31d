"""The rate of BW stats' copies to the card: the program's
``lia.stats.h2d_bytes`` counter over the device time of the operations
launched under its ``lia.stats.h2d`` spans, in the profiled sub-window
(GB/s, 1e9 bytes)."""

from benchmark import program


def read(ctx):
    nbytes = program.counter("lia.stats.h2d_bytes")
    secs = (ctx.trace.span_device_seconds("lia.stats.h2d")
            if ctx.trace is not None else None)
    return nbytes / secs / 1e9 if nbytes and secs else None
