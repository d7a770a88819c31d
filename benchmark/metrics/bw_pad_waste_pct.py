"""The share of the frames sent to K2 that are padding: 100 × (frames
sent − the utterances' own frames) / frames sent, from the program's
``lia.stats.frames_sent`` and ``lia.stats.frames_carried`` counters in
the profiled sub-window."""

from benchmark import program


def read(ctx):
    sent = program.counter("lia.stats.frames_sent")
    carried = program.counter("lia.stats.frames_carried")
    if not sent or carried is None:
        return None
    return 100.0 * (sent - carried) / sent
