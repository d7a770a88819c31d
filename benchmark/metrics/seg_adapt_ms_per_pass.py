"""Host milliseconds a pass in the E-HMM's and ReSegmentation's batched
state adaptations: the summed length of the program's ``lia.seg.adapt``
spans (masks built on the host and copied, then one ``adapt_model`` a
state row, 3 K1 launches each) in the profiled sub-window, over its
passes."""

from benchmark import program


def read(ctx):
    secs, n = program.span_seconds(ctx, "lia.seg.adapt"), program.passes(ctx)
    return 1e3 * secs / n if secs is not None and n else None
