"""The port's oracle parity run (scripts/torch_oracle_parity.py) on the
CPU at a cut corpus: native/oracle.cpp is built (g++, the Makefile's
flags) into a temporary directory, the port's CLI chain runs with
``torchDevice cpu``, and the stage comparisons hold the bounds of
chip_smoke.py phase 13: per-trial top-10 LLR within 1e-3 of the f64
oracle's from the same models, i-vectors within 1e-3 of the oracle's
scale.  The EER deltas are printed (target 0.0), not bounded.
"""

import os
import sys
import time

import torch

from lia_ral_tpu_torch import _build

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "scripts"))

import torch_oracle_parity as top  # noqa: E402

# scripts/milestone_eer.py's small scale, cut: K=16, D=6, R=8, 12
# speakers and 36 trials, 4000 background frames, 2 EM and 2 TV iterations
TINY = dict(top.SCALES["small"], k=16, d=6, r=8, n_spk=4, n_imp=2, n_dev=8,
            sess=3, t_utt=200, t_test=100, n_test=3, bg=4000, ubm_it=2,
            tv_it=2)


def test_oracle_parity_on_a_cut_corpus(tmp_path, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    t0 = time.perf_counter()
    out = top.run(str(tmp_path / "work"), TINY, device="cpu", threads=2)
    assert list((tmp_path / "build").glob("oracle_*"))
    res = out["results"]
    for line in top.report(res):
        print(line)
    assert out["shapes"]["n_trials"] == TINY["n_spk"] ** 2 * TINY["n_test"]
    assert res["score_llr"]["max"] <= 1e-3, res["score_llr"]
    assert res["ivector"]["max"] <= 1e-3 * res["ivector_scale"], \
        (res["ivector"], res["ivector_scale"])
    for key in ("gmm_eer_delta_vs_oracle", "iv_eer_delta_vs_oracle"):
        assert 0.0 <= res[key] <= 1.0
    assert time.perf_counter() - t0 < 30
