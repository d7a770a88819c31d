"""Device-idle milliseconds a pass inside ``fa.tv.estimate_w``: the part
of the program's ``lia.fa.estimate_w`` spans in which no operation ran
on the card (PCG's host checks, launch gaps), over the profiled
sub-window's passes."""

from benchmark import program


def read(ctx):
    secs = program.idle_seconds_inside(ctx, "lia.fa.estimate_w")
    n = program.passes(ctx)
    return 1e3 * secs / n if secs is not None and n else None
