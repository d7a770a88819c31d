#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3

Every run makes its set-up and a window of ``--seconds`` at the cell's
own load.  For each of ``--seeds`` the program's output is compared with
the float64 reference (the lower readings); for each of
``--control-seeds`` the control, which is the reference computed in TF32
in the program's place (float32 with TF32 off is what the configurations
state), is judged the same way (the upper readings).  ``--fault`` plants
one of the faults of the cell's driver (its ``FAULTS``, by name) in the
program's runs.  Prints one JSON line per run:
``{"seed", "kind": "program" | "control", "readings": {name: value}}``.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import core, run  # noqa: E402


def readings(cell: str, seed: int, seconds: float, kind: str,
             device: str = "cuda", tiny: bool = False,
             fault: str | None = None) -> dict:
    """The readings of one run: the program's (``kind`` "program", with
    ``fault`` planted if given) or the control's; ``tiny`` cuts widths
    and traffic to the workload's ``tiny`` entry."""
    _, cfg, traffic, drv = run.load_cell(cell, tiny)
    patch = core.Patch()
    if fault:
        drv.FAULTS[fault](patch)
    try:
        return _readings(drv, cell, cfg, traffic, seed, seconds, kind,
                         device)
    finally:
        patch.undo()


def _readings(drv, cell, cfg, traffic, seed, seconds, kind, device):
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="bench_")
    try:
        ctx = run.context(cell, cfg, traffic, seed, dev, tmp)
        st = drv.setup(ctx)
        drv.window(st, seconds, core.Recorder(dev))
        drv.release(st)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        judged = (drv.judge if kind == "program" else drv.control)(st, {})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {name: value for name, value, _ in judged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault",
                    help="plant this fault of the cell's driver in the "
                    "program's runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    print(f"card: {core.card_line()}", file=sys.stderr)
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            r = readings(args.workload, int(s), args.seconds, kind,
                         fault=args.fault if kind == "program" else None)
            label = (f"fault:{args.fault}" if kind == "program"
                     and args.fault else kind)
            print(json.dumps({"seed": int(s), "kind": label,
                              "readings": r}), flush=True)
    found = core.forbidden_loaded()
    if found:
        print("JAX or the JAX package is loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
