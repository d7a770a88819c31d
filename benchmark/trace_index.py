"""A kernel's share of its roofline where the harness's span around it
opens thousands of times a pass, as in the diarization cell (~7,000 K1
calls and ~280,000 device operations a pass).

``core.Trace.span_device_seconds`` tests every operation against every
range of the span's name, which there takes minutes.  This gives the
same quantity, the summed device time of the operations whose launch
falls inside a range of that name on the launching thread, from the
ranges sorted by start on each thread (ranges of one name do not nest:
one call at a time), in O(operations · log ranges)."""

from __future__ import annotations

import bisect

from benchmark import flops


def span_device_seconds(tr, span: str) -> float | None:
    ranges: dict = {}
    for name, ts, dur, tid in tr.annotations:
        if name == span:
            ranges.setdefault(tid, []).append((ts, ts + dur))
    if not ranges:
        return None
    for v in ranges.values():
        v.sort()
    starts = {tid: [a for a, _ in v] for tid, v in ranges.items()}
    total, found = 0.0, False
    for _, _, dur, corr in tr.ops:
        launch = tr.launches.get(corr)
        if launch is None or launch[1] not in ranges:
            continue
        lts, tid = launch
        i = bisect.bisect_right(starts[tid], lts) - 1
        if i >= 0 and lts <= ranges[tid][i][1]:
            total += dur
            found = True
    return total * 1e-6 if found else None


def roofline_pct(ctx, span: str) -> float | None:
    """``core.roofline_pct`` with the device time above."""
    calls = ctx.prof.costs.get(span)
    if not calls or ctx.trace is None:
        return None
    spent = span_device_seconds(ctx.trace, span)
    if not spent:
        return None
    least = sum(flops.least_seconds(float(f), float(b))[0]
                for f, b in calls)
    return 100.0 * least / spent
