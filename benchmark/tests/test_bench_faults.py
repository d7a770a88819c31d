"""Each fault a cell can have, planted under the timed path at the
cell's tiny size, makes the comparison fail one of the cell's limits
(each driver's ``FAULTS``: a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced); a sound
run of the same size passes all of them.  A cell added later brings its
faults in its own driver."""

import pytest

from benchmark import control, run

SEED = 2**31 + 99
CELLS = [w["name"] for w in run.load_json(run.ROOT, "BENCHMARK.json")
         ["workloads"]]
CASES = [(cell, name) for cell in CELLS
         for name in getattr(run.load_cell(cell)[3], "FAULTS", {})]


def _failed(cell, fault):
    limits = run.load_json(run.HERE, "workloads", f"{cell}.json")["limits"]
    got = control.readings(cell, SEED, 0.5, "program", device="cpu",
                           tiny=True, fault=fault)
    return [n for n, v in got.items() if not v <= limits[n]], got


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_fails_a_limit(cell, fault):
    failed, got = _failed(cell, fault)
    assert failed, got


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes_every_limit(cell):
    failed, got = _failed(cell, None)
    assert not failed, got
