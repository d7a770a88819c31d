"""Every cell runs end to end at its tiny size on the CPU and prints the
result line the benchmark prints; the command itself refuses to run without a
card; nothing of JAX is loaded."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from benchmark import core, run

CELLS = [w["name"] for w in run.load_json(run.ROOT, "BENCHMARK.json")
         ["workloads"]]
SEED = 2**31 + 12345


def _line(cell, trace):
    result, checks = run.run_cell(cell, SEED, 1.0, trace, device="cpu",
                                  tiny=True)
    buf = io.StringIO()
    with redirect_stdout(buf):
        core.emit(result, checks)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_the_result_line(cell, trace):
    line = _line(cell, trace)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    e2e, per = run.cell_metrics(bench, cell)
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in per}
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
    for m in line["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_command_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_jax_after_a_dry_run_of_every_cell():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {run.ROOT!r})\n"
        "from benchmark import run, core\n"
        f"for cell in {CELLS!r}:\n"
        "    for trace in (False, True):\n"
        "        run.run_cell(cell, 7, 0.5, trace, device='cpu', tiny=True)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(core.forbidden_loaded())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops, found = proc.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    for name in ("jax", "jaxlib", "flax", "lia_ral_tpu"):
        assert f"'{name}'" not in tops
    assert "'lia_ral_tpu_torch'" in tops


def test_benchmark_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    import shutil

    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from benchmark import run, core\n"
        f"r, c = run.run_cell({CELLS[0]!r}, 1, 0.5, False, device='cpu',"
        " tiny=True)\n"
        "core.emit(r, c)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "lia_ral_tpu_torch" in proc.stderr
