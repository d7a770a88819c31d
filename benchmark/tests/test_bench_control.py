"""The control of every cell comes out not correct: the reference put in
the program's place in TF32, the precision below the float32 (TF32 off)
that the configurations state, fails at least one of the cell's limits.
On the card only (TF32 is a tensor-core mode), at each cell's own size
with a two-second window (``benchmark/control.py`` reads the same over
several seeds); about three minutes for the three cells."""

import os

import pytest

from benchmark import control, run

CELLS = sorted(f[:-5] for f in os.listdir(os.path.join(run.HERE, "workloads"))
               if f.endswith(".json"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    limits = run.load_json(run.HERE, "workloads", f"{cell}.json")["limits"]
    got = control.readings(cell, 2**31 + 5, 2.0, "control",
                           device=str(card))
    assert any(not v <= limits[n] for n, v in got.items() if n in limits)
