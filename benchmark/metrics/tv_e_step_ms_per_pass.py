"""Host milliseconds a pass in the T-matrix E-step: the summed length of
the program's ``lia.tv.e_step`` spans (E_c, F̄, and each 64-session
chunk's posteriors and accumulation) in the profiled sub-window, over
its passes."""

from benchmark import program


def read(ctx):
    secs, n = program.span_seconds(ctx, "lia.tv.e_step"), program.passes(ctx)
    return 1e3 * secs / n if secs is not None and n else None
