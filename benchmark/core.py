"""The harness's machinery shared by every cell: spans on the host clock,
the profiled sub-window and its reduction, the window loop of whole
passes, the result line, and the guard against JAX in the process.

Nothing here knows a cell: drivers, configurations, traffic mixes and
per-layer readers are files of their own, found by name (``run.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lia_ral_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float


class Recorder:
    """The harness's spans around calls into the program.  ``annotate``
    opens a profiler range of the span's name (read by the trace
    reduction); ``timed`` also takes its host-clock length, ending in a
    synchronise.  Both off: a span costs nothing."""

    def __init__(self, device, annotate: bool = False,
                 timed: bool = False) -> None:
        self.device = device
        self.annotate = annotate
        self.timed = timed
        self.spans: list[Span] = []
        self.costs: dict[str, list[tuple[float, float]]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not (self.annotate or self.timed):
            yield
            return
        ann = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        with ann:
            if self.timed:
                sync(self.device)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.timed:
                    sync(self.device)
                self.spans.append(Span(name, t0, time.perf_counter()))

    def cost(self, name: str, flops, nbytes) -> None:
        """The operations and bytes of one call under span ``name``
        (numbers, or 0-d tensors still on the device, read after the
        profiled sub-window has closed)."""
        if self.annotate:
            self.costs.setdefault(name, []).append((flops, nbytes))

    def span_seconds(self, name: str) -> list[float]:
        return [s.t1 - s.t0 for s in self.spans if s.name == name]


@dataclasses.dataclass
class Window:
    """What a measured window did: end-to-end values by metric name,
    the work attempted and failed, and what per-layer readers use."""

    values: dict
    attempted: int
    failed: int
    elapsed: float
    extra: dict = dataclasses.field(default_factory=dict)


def run_passes(step, seconds: float, device) -> tuple[int, float]:
    """Whole passes back to back until ``seconds`` have passed at the end
    of one: (passes, elapsed s).  Each pass ends in a synchronise, so
    the elapsed time covers all the work counted.  Prints the passes'
    shortest, median and longest seconds on standard error."""
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        step(len(ends) - 1)
        sync(device)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            secs = sorted(b - a for a, b in zip(ends, ends[1:]))
            print(f"passes: {len(secs)}, seconds each: shortest "
                  f"{secs[0]:.4f}, median {secs[len(secs) // 2]:.4f}, "
                  f"longest {secs[-1]:.4f}", file=sys.stderr)
            return len(secs), ends[-1] - t0


# -- faults planted under the timed path --------------------------------------

class Patch:
    """``setattr(owner, name, value)`` that ``undo`` puts back: how a
    driver's ``FAULTS`` planters replace a function of the program (the
    CPU tests pass pytest's ``monkeypatch`` instead)."""

    def __init__(self):
        self._undo = []

    def setattr(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self._undo:
            owner, name, value = self._undo.pop()
            setattr(owner, name, value)


def first_half(w):
    """1 on the first half of each row's weighted frames, 0 after."""
    return (torch.cumsum(w, -1) <= w.sum(-1, keepdim=True) / 2).to(w)


# -- the profiled sub-window --------------------------------------------------

@dataclasses.dataclass
class Trace:
    """The reduction of a profiled sub-window: device operations
    (name, start µs, length µs, correlation), launches by correlation
    (start µs, thread), host annotations (name, start µs, length µs,
    thread), and the window's bounds (µs)."""

    ops: list
    launches: dict
    annotations: list
    w0: float
    w1: float
    host_spans: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    def _union(self, ivs):
        out = []
        for a, b in sorted(ivs):
            a, b = max(a, self.w0), min(b, self.w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_intervals(self):
        return self._union([(ts, ts + dur) for _, ts, dur, _ in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def span_device_seconds(self, span: str) -> float | None:
        """Summed device time of the operations launched while a host
        annotation named ``span`` was open on the launching thread."""
        spans = [(ts, ts + dur, tid) for name, ts, dur, tid
                 in self.annotations if name == span]
        if not spans:
            return None
        total, found = 0.0, False
        for _, _, dur, corr in self.ops:
            launch = self.launches.get(corr)
            if launch is None:
                continue
            lts, ltid = launch
            if any(a <= lts <= b and ltid == tid for a, b, tid in spans):
                total += dur
                found = True
        return total * 1e-6 if found else None

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, _, dur, _ in self.ops:
            by[name] = by.get(name, 0.0) + dur * 1e-6
        return [[k[:160], v] for k, v in sorted(by.items(),
                                                key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time by the innermost harness span open on the host,
        on any thread, during each gap (summed per span name)."""
        busy = self.busy_intervals()
        gaps, cur = [], self.w0
        for a, b in busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < self.w1:
            gaps.append((cur, self.w1))
        anns = self.host_spans
        by = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            open_ = [(e - s, name) for s, e, name in anns if s <= mid <= e]
            label = min(open_)[1] if open_ else "no harness span open"
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


def reduce_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, launches, anns = [], {}, []
    w0 = w1 = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        args = ev.get("args", {}) or {}
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((ev.get("name", "?"), ts, dur,
                        args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (ts, ev.get("tid"))
        elif cat == "user_annotation":
            anns.append((ev.get("name", ""), ts, dur, ev.get("tid")))
            if ev.get("name") == WINDOW_SPAN:
                w0, w1 = ts, ts + dur
    if w0 is None:
        raise RuntimeError(f"trace {path} holds no {WINDOW_SPAN} span")
    return Trace(ops, launches, anns, w0, w1)


def profile(fn, device, tmpdir: str, rec: Recorder
            ) -> tuple[object, Trace]:
    """Run ``fn()`` under torch.profiler (host and, on a card, device
    activity) inside a ``bench.window`` range; returns (fn's result, the
    reduced trace).  ``rec``'s host-clock spans, from any thread, are
    placed on the trace's clock from the window's start.  The trace file
    goes under ``tmpdir`` and is deleted once read."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(tmpdir, "bench_trace.json")
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            host0 = time.perf_counter()
            out = fn()
            sync(device)
    prof.export_chrome_trace(path)
    try:
        tr = reduce_chrome_trace(path)
    finally:
        os.unlink(path)
    tr.host_spans = [(tr.w0 + (s.t0 - host0) * 1e6,
                      tr.w0 + (s.t1 - host0) * 1e6, s.name)
                     for s in rec.spans]
    return out, tr


# -- device, guard, result ----------------------------------------------------

def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def forbidden_loaded() -> list[str]:
    """Modules whose top-level name is JAX's, its libraries' or the JAX
    package's (compared whole: lia_ral_tpu_torch is not lia_ral_tpu)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def emit(result: dict, checks: list) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; then the result line, with them under its last key,
    as the last line of standard output."""
    for name, value, limit in checks:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


# -- what the per-layer readers share -----------------------------------------

def roofline_pct(ctx, span: str) -> float | None:
    """100 × (the least time of the calls under ``span``, from their
    operations and bytes) / (the device time of every operation they
    launched), from the profiled sub-window; None where no call ran."""
    from benchmark import flops

    calls = ctx.prof.costs.get(span)
    if not calls or ctx.trace is None:
        return None
    spent = ctx.trace.span_device_seconds(span)
    if not spent:
        return None
    least = sum(flops.least_seconds(float(f), float(b))[0]
                for f, b in calls)
    return 100.0 * least / spent


def idle_pct(ctx) -> float | None:
    """100 × the share of the profiled sub-window in which no operation
    ran on the device."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def span_ms(ctx, span: str) -> float | None:
    """Mean host-clock milliseconds of a timed span in the window."""
    secs = ctx.rec.span_seconds(span)
    return 1e3 * sum(secs) / len(secs) if secs else None
