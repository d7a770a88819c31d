"""Host milliseconds a pass spent padding BW-stats batches: the summed
length of the program's ``lia.stats.pad`` spans (``np.zeros`` of each
batch and its row fill, in ``fa.stats.bw_stats_bucketed``) in the
profiled sub-window, over its passes."""

from benchmark import program


def read(ctx):
    secs, n = program.span_seconds(ctx, "lia.stats.pad"), program.passes(ctx)
    return 1e3 * secs / n if secs is not None and n else None
