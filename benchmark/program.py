"""What the readers of the program's own spans and counters share.

The port records spans named ``lia.*`` (``lia_ral_tpu_torch.utils.
logging.span``) as profiler ranges, so they sit in the profiled
sub-window's trace beside the harness's ``bench.*`` spans, and it counts
into ``lia_ral_tpu_torch.utils.logging.counters`` only while a profiler
records: in a benchmark process the counters hold the profiled
sub-window alone.  Each helper returns None where the program has no
such span or counter (a version of the port without them)."""

from __future__ import annotations

from lia_ral_tpu_torch.utils import logging as program_log


def passes(ctx) -> int | None:
    """The profiled sub-window's passes."""
    sub = ctx.window.extra.get("profiled") or {}
    return sub.get("passes") or None


def counter(name: str) -> int | None:
    """The program's counter ``name``, or None where it has none."""
    counters = getattr(program_log, "counters", None)
    return None if counters is None else counters.get(name)


def span_seconds(ctx, name: str) -> float | None:
    """Summed host length of the program's ``name`` ranges in the
    profiled sub-window."""
    if ctx.trace is None:
        return None
    lengths = [dur for n, _, dur, _ in ctx.trace.annotations if n == name]
    return sum(lengths) * 1e-6 if lengths else None


def idle_seconds_inside(ctx, name: str) -> float | None:
    """Device-idle time inside the program's ``name`` ranges: their
    union less its overlap with the union of device operations."""
    tr = ctx.trace
    if tr is None:
        return None
    inside = tr._union([(ts, ts + dur) for n, ts, dur, _ in tr.annotations
                        if n == name])
    if not inside:
        return None
    busy = tr.busy_intervals()
    idle = 0.0
    for a, b in inside:
        idle += (b - a) - sum(max(0.0, min(b, y) - max(a, x))
                              for x, y in busy if x < b and y > a)
    return idle * 1e-6
