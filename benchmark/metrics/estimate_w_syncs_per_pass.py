"""Host reads of a device value in ``fa.tv.estimate_w`` a pass (PCG's
exit checks): the program's ``lia.tv.host_syncs`` counter over the
profiled sub-window's passes, where its ``lia.tv.blocks`` shows the
call ran."""

from benchmark import program


def read(ctx):
    syncs, n = program.counter("lia.tv.host_syncs"), program.passes(ctx)
    if syncs is None or not n or not program.counter("lia.tv.blocks"):
        return None
    return syncs / n
