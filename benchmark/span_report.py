#!/usr/bin/env python3
"""Where a cell's device time and idle time fall among the program's own
spans: the cell's profiled sub-window (its ``profiled`` function, two
passes) run once for each seed after its set-up, at the cell's size.

    python3 benchmark/span_report.py --workload <cell> --seed <n> [<n> ...] [--out FILE]

For each seed it prints one JSON line (appended to ``--out`` too): the
sub-window's length a pass; the device's idle time by the innermost
``lia.*`` span open on the host (each idle interval cut where a span
opens or closes), and the share of it under a span nested below a
call's outermost one; the device time under each program kernel span
beside the harness's span around the same call; the program's counters;
and the value of every per-layer metric ``BENCHMARK.json`` lists for the
cell.  Runs on the CUDA card, as the benchmark does (``--device cpu
--tiny`` rehearses it on the CPU at the cell's tiny size, where no
operation runs on a device and every interval is idle).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import types

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark import core, run  # noqa: E402

PREFIX = "lia."
# the program's spans whose device time is reported; each kernel span
# beside the harness's span around the same call
DEVICE_SPANS = ("lia.gmm.em_stats_fused", "bench.k1",
                "lia.gmm.bw_stats_fused", "bench.k2", "lia.stats.h2d",
                "lia.fa.bw_stats_bucketed", "lia.fa.estimate_w",
                "lia.gmm.train_model")


def idle_gaps(tr) -> list:
    """Intervals (µs) of the sub-window in which no operation ran."""
    gaps, cur = [], tr.w0
    for a, b in tr.busy_intervals():
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < tr.w1:
        gaps.append((cur, tr.w1))
    return gaps


def idle_by_span(tr) -> tuple[dict, float, dict]:
    """(idle seconds by innermost program span, or "no lia span"; idle
    seconds under a program span with another program span around it;
    the rest, under an outermost program span alone, by the innermost
    harness span open and the program span that closed last before)."""
    spans = sorted((ts, ts + dur, name) for name, ts, dur, _
                   in tr.annotations if name.startswith(PREFIX))
    harness = [(ts, ts + dur, name) for name, ts, dur, _ in tr.annotations
               if name.startswith("bench.")]
    ends = sorted((b, name) for _, b, name in spans)
    by: dict = {}
    alone: dict = {}
    nested = 0.0
    for a, b in idle_gaps(tr):
        over = [s for s in spans if s[0] < b and s[1] > a]
        cuts = sorted({a, b} | {t for s in over for t in s[:2]
                                if a < t < b})
        for x, y in zip(cuts, cuts[1:]):
            mid = 0.5 * (x + y)
            open_ = [(s[1] - s[0], s[2]) for s in over
                     if s[0] <= mid <= s[1]]
            label = min(open_)[1] if open_ else "no lia span"
            by[label] = by.get(label, 0.0) + (y - x) * 1e-6
            if len(open_) >= 2:
                nested += (y - x) * 1e-6
            elif open_:
                bench = min(((e - s, n) for s, e, n in harness
                             if s <= mid <= e), default=(0, "-"))[1]
                i = bisect.bisect_right(ends, (x, "~"))
                after = ends[i - 1][1] if i else "-"
                key = f"{bench} after {after}"
                alone[key] = alone.get(key, 0.0) + (y - x) * 1e-6
    return by, nested, alone


def report(cell: str, seed: int, tmp: str, device: str = "cuda",
           tiny: bool = False) -> dict:
    from lia_ral_tpu_torch.utils import logging as program_log

    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, cfg, traffic, drv = run.load_cell(cell, tiny)
    ctx = run.context(cell, cfg, traffic, seed, device, tmp)
    st = drv.setup(ctx)
    core.sync(ctx.device)
    program_log.reset_counters()
    prof = core.Recorder(ctx.device, annotate=True)
    sub, tr = core.profile(lambda: drv.profiled(st, prof), ctx.device, tmp,
                           prof)
    passes = sub["passes"]

    def per_pass(v):
        return None if v is None else v / passes
    win = core.Window(values={}, attempted=passes, failed=0,
                      elapsed=tr.window_s, extra={"profiled": sub})
    rctx = types.SimpleNamespace(window=win, trace=tr, prof=prof, cell=cell,
                                 rec=core.Recorder(ctx.device))
    _, per = run.cell_metrics(bench, cell)
    metrics = {m["name"]: run.metric_reader(m["name"]).read(rctx)
               for m in per}
    by, nested, alone = idle_by_span(tr)
    idle = tr.window_s - tr.busy_s
    drv.release(st)
    return {
        "cell": cell, "seed": seed, "card": core.card_line(),
        "passes": passes, "window_s_per_pass": tr.window_s / passes,
        "busy_s_per_pass": tr.busy_s / passes,
        "idle_s_per_pass": idle / passes,
        "idle_s_by_innermost_lia_span_per_pass": {
            k: v / passes for k, v in sorted(by.items(),
                                             key=lambda kv: -kv[1])},
        "idle_share_nested_pct": 100.0 * nested / idle if idle > 0 else None,
        "idle_s_outermost_alone_per_pass": {
            k: v / passes for k, v in sorted(alone.items(),
                                             key=lambda kv: -kv[1])[:12]},
        "device_s_per_pass": {name: per_pass(tr.span_device_seconds(name))
                              for name in DEVICE_SPANS},
        "counters_per_pass": {k: v / passes
                              for k, v in program_log.counters.items()},
        "metrics": metrics,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--out", help="append each JSON line here too")
    ap.add_argument("--device", default="cuda",
                    help="cpu, with --tiny, rehearses the report")
    ap.add_argument("--tiny", action="store_true",
                    help="the cell's tiny size (the CPU tests')")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("span_report: no CUDA card", file=sys.stderr)
        return 3
    with tempfile.TemporaryDirectory(prefix="span_report_") as tmp:
        for seed in args.seed:
            line = json.dumps(report(args.workload, seed, tmp, args.device,
                                     args.tiny))
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
