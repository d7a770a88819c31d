#!/usr/bin/env python3
"""The benchmark of lia_ral_tpu_torch on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's name finds everything by file: ``benchmark/workloads/<cell>.json``
(the traffic, its configuration's name, its driver and its limits),
``benchmark/configs/<config>.json`` (the widths), ``benchmark/drivers/
<driver>.py`` (set-up, the timed window, the profiled sub-window and the
comparison with the plain reference) and, for ``--trace 1``, one reader
``benchmark/metrics/<metric>.py`` per per-layer metric that
``BENCHMARK.json`` gives the cell (a name split by stage, such as
``mfu.train``, falls back to the reader of its base name, ``mfu.py``).  A new cell or metric is new files and
new entries; no file here changes.

Set-up (data made on the card from the seed, the program's warm-up) is
timed as ``setup_s``; then the window measures for ``--seconds``; with
``--trace 1`` a profiled sub-window of whole passes follows it.  After
the window the peak memory is read, the program's state is freed, and
the cell's driver module compares what the timed path produced with its
plain reference in float64.  The last line of standard output is the result;
the numbers compared, each beside its limit, close standard error.
Exits non-zero, printing no result, without a CUDA card, when the
comparison cannot run, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")

import torch  # noqa: E402

from benchmark import core  # noqa: E402


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def metric_reader(name: str) -> types.ModuleType:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    that of the part before the first dot where the name has no file."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return load_module(path, "bench_metric_" + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader of metric {name!r} in "
                            f"{os.path.join(HERE, 'metrics')}")


def deep_update(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (deep_update(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def load_cell(cell: str, tiny: bool = False):
    """(workload, configuration, traffic, driver module) of ``cell``;
    ``tiny`` cuts widths and traffic to the workload's ``tiny`` entry
    (the CPU tests)."""
    wl = load_json(HERE, "workloads", f"{cell}.json")
    cfg = load_json(HERE, "configs", f"{wl['config']}.json")
    traffic = wl["traffic"]
    if tiny:
        traffic = deep_update(traffic, wl.get("tiny", {}).get("traffic", {}))
        cfg = deep_update(cfg, wl.get("tiny", {}).get("config", {}))
    drv = load_module(os.path.join(HERE, "drivers", f"{wl['driver']}.py"),
                      f"bench_driver_{wl['driver']}")
    return wl, cfg, traffic, drv


def context(cell, cfg, traffic, seed, device, tmp):
    """What a driver's set-up gets."""
    return types.SimpleNamespace(cell=cell, cfg=cfg, traffic=traffic,
                                 seed=seed, device=torch.device(device),
                                 tmp=tmp)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", tiny: bool = False) -> tuple[dict, list]:
    """Run one cell; returns (result without its checks, checks)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    if not any(w["name"] == cell for w in bench["workloads"]):
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    wl, cfg, traffic, drv = load_cell(cell, tiny)
    e2e, per = cell_metrics(bench, cell)
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="bench_")
    try:
        ctx = context(cell, cfg, traffic, seed, dev, tmp)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state = drv.setup(ctx)
        core.sync(dev)
        setup_s = time.perf_counter() - t0
        rec = core.Recorder(dev, timed=trace)
        win = drv.window(state, seconds, rec)
        tr = None
        prof_rec = core.Recorder(dev, annotate=True)
        if trace:
            sub, tr = core.profile(lambda: drv.profiled(state, prof_rec),
                                   dev, tmp, prof_rec)
            win.extra["profiled"] = sub
        info = core.device_info(dev)
        drv.release(state)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        checks = drv.judge(state, wl.get("limits", {}))
        print(f"reference and comparison: {time.perf_counter() - t1:.3f} s",
              file=sys.stderr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    metrics = {}
    if not trace:
        for m in e2e:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] in win.values:
                value = win.values[m["name"]]
            else:
                raise KeyError(f"cell {cell} gives no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rctx = types.SimpleNamespace(window=win, trace=tr, rec=rec,
                                     prof=prof_rec, cell=cell)
        for m in per:
            value = metric_reader(m["name"]).read(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
        matched = sum(1 for op in tr.ops if op[3] in tr.launches)
        print(f"trace: {len(tr.ops)} device operations, "
              f"{len(tr.launches)} launches, {matched} operations matched "
              f"to their launch, {len(tr.annotations)} host ranges",
              file=sys.stderr)
    correct = all(lim is not None and value <= lim
                  for _, value, lim in checks)
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    return result, checks


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"card: {core.card_line()}", file=sys.stderr)
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    found = core.forbidden_loaded()
    if found:
        print("JAX or the JAX package is loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    core.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
