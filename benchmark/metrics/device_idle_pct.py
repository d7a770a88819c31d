"""The share of the profiled sub-window in which no operation ran on the
card (100 % less the union of device operations' intervals).  Read for
every ``device_idle_pct.<stage>``."""

from benchmark import core


def read(ctx):
    return core.idle_pct(ctx)
