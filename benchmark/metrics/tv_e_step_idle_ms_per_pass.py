"""Device-idle milliseconds a pass inside the T-matrix E-step: the part
of the program's ``lia.tv.e_step`` spans in which no operation ran on the
card (the host's waits on each chunk's Cholesky, launch gaps), over the
profiled sub-window's passes."""

from benchmark import program


def read(ctx):
    secs = program.idle_seconds_inside(ctx, "lia.tv.e_step")
    n = program.passes(ctx)
    return 1e3 * secs / n if secs is not None and n else None
