"""A cell or a per-layer metric that a later change adds is found by
name: new files and new entries only, no existing file edited.  A metric
split by stage (``mfu.em2``) is read by its base name's reader."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import run


def test_added_workload_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(run.ROOT, "lia_ral_tpu_torch"),
               root / "lia_ral_tpu_torch")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}

    base = root / "benchmark" / "workloads" / "ivec_dehak2011.ubm_em.json"
    wl = json.loads(base.read_text())
    wl["traffic"]["nb_train_it"] = 2
    (root / "benchmark" / "workloads" / "ivec_dehak2011.ubm_em2.json"
     ).write_text(json.dumps(wl))
    (root / "benchmark" / "metrics" / "passes_profiled.py").write_text(
        "def read(ctx):\n"
        "    return float(ctx.window.extra['profiled']['passes'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "ivec_dehak2011.ubm_em2", "config": "ivec_dehak2011",
        "traffic": "ubm_em2", "chips": 1, "why": "two iterations a call"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ivec_dehak2011.ubm_em" in m["workloads"]:
            m["workloads"].append("ivec_dehak2011.ubm_em2")
    bench["per_layer"].append({
        "name": "passes_profiled", "unit": "passes", "better": "higher",
        "source": "program_counter", "layer": "library",
        "moves": "audio_s_per_s.train",
        "workloads": ["ivec_dehak2011.ubm_em2"]})
    bench["per_layer"].append({
        "name": "mfu.em2", "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "the whole step",
        "moves": "audio_s_per_s.train",
        "workloads": ["ivec_dehak2011.ubm_em2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from benchmark import run\n"
        "assert run.ROOT == " + repr(str(root)) + "\n"
        "out = [run.run_cell('ivec_dehak2011.ubm_em2', 3, 0.5, t,"
        " device='cpu', tiny=True)[0] for t in (False, True)]\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    plain, traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(plain["metrics"]) == {"audio_s_per_s.train", "setup_s"}
    assert traced["metrics"]["passes_profiled"]["value"] == 2.0
    assert traced["metrics"]["mfu.em2"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
