"""Host milliseconds a pass in the E-HMM's and ReSegmentation's decodes:
the summed length of the program's ``lia.seg.decode`` spans (the
emission block, the Viterbi kernel's launch, the path and, in the E-HMM,
the emissions read back) in the profiled sub-window, over its passes."""

from benchmark import program


def read(ctx):
    secs, n = program.span_seconds(ctx, "lia.seg.decode"), program.passes(ctx)
    return 1e3 * secs / n if secs is not None and n else None
