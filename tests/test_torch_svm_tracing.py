"""The spans and counters of the port's SVM back end (``backend.svm``,
``backend.supervector``; ``utils.logging``): under a profiler each
``lia.svm.*`` counter equals its closed form in the run's shapes (solves,
ΣN, ΣN², steps, support vectors, bytes copied), the spans nest where the
work happens; with no profiler every counter stays 0 and the models are
the same.  Small sizes on the CPU, few FISTA steps (the profiler records
each operation of the plain loop)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from lia_ral_tpu_torch.backend import supervector as tsv
from lia_ral_tpu_torch.backend import svm as tsvm
from lia_ral_tpu_torch.utils import logging as tlog
from torch.autograd import profiler

import _torch_parity  # noqa: F401  (two torch threads a test worker)

SVM = [name for name in tlog.counters if name.startswith("lia.svm.")]
D, STEPS, RANK = 24, 20, 2


def _problem(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32) + 3.0
    x[0] += 1.0
    return torch.from_numpy(x), np.r_[1.0, -np.ones(n - 1)].astype(
        np.float32)


def _run(rng):
    """Two linear solves (N = 12 and 30) and one rbf solve (N = 12), a
    decision of 5 vectors by each model, NAP's training and a
    projection."""
    out = []
    for n, kind in ((12, "linear"), (30, "linear"), (12, "rbf")):
        x, y = _problem(rng, n)
        model = tsvm.svm_train(x, y, kind=kind, n_iter=STEPS)
        out.append((n, kind, model, model.decision(x[:5])))
    v = torch.from_numpy(rng.standard_normal((12, D)).astype(np.float32))
    u = tsv.train_nap_subspace(v, torch.arange(4).repeat_interleave(3), 4,
                               RANK)
    out.append(tsv.nap_project_vectors(v, u))
    return out


def _ranges(logdir: Path):
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] and p[3] == child[3]
               for p in parents)


def test_without_a_profiler_every_svm_counter_stays_zero():
    assert not profiler._is_profiler_enabled and not tlog.recording()
    before = dict(tlog.counters)
    _run(np.random.default_rng(3))
    assert tlog.counters == before


def test_counters_equal_their_closed_forms_and_spans_nest(tmp_path):
    plain = _run(np.random.default_rng(3))
    with tlog.profile_trace(str(tmp_path / "tr")):
        traced = _run(np.random.default_rng(3))
    counted = json.loads((tmp_path / "tr" / "counters.json").read_text())
    for (n, kind, m0, d0), (_, _, m1, d1) in zip(plain[:3], traced[:3]):
        np.testing.assert_array_equal(m0.support, m1.support)
        np.testing.assert_array_equal(m0.alpha_y, m1.alpha_y)
        assert m0.bias == m1.bias and torch.equal(d0, d1)
    assert torch.equal(plain[3], traced[3])

    solves = [(n, kind, m) for n, kind, m, _ in traced[:3]]
    ns = [n for n, _, _ in solves]
    sv = [m.support.shape[0] for _, _, m in solves]
    assert counted["lia.svm.solves"] == 3
    assert counted["lia.svm.vectors"] == sum(ns)
    assert counted["lia.svm.q_entries"] == sum(n * n for n in ns)
    assert counted["lia.svm.dual_steps"] == STEPS * sum(n * n for n in ns)
    assert counted["lia.svm.dual_step_vectors"] == STEPS * sum(ns)
    assert counted["lia.svm.support"] == sum(sv)
    # off the card nothing crosses between host and card: y, C and the
    # model stay on the CPU, and so do the decisions' support rows
    assert counted["lia.svm.h2d_bytes"] == 0
    assert counted["lia.svm.d2h_bytes"] == 0
    # one read of the support count and the bias a solve; none a decision
    assert counted["lia.svm.host_syncs"] == len(solves)
    assert set(SVM) <= set(counted)

    ranges = _ranges(tmp_path / "tr")

    def named(name):
        return [r for r in ranges if r[0] == name]
    trains = named("lia.svm.train")
    assert len(trains) == 3
    for child, per in (("lia.svm.bounds", 1), ("lia.svm.gram", 1),
                       ("lia.svm.dual", 1), ("lia.svm.model", 1)):
        assert len(named(child)) == per * len(trains), child
        assert all(_inside(r, trains) for r in named(child)), child
    assert len(named("lia.svm.decision")) == 3
    assert not any(_inside(r, trains) for r in named("lia.svm.decision"))
    assert len(named("lia.sv.nap_train")) == len(named("lia.sv.nap")) == 1


def test_every_svm_counter_is_listed():
    assert set(SVM) == {"lia.svm.solves", "lia.svm.vectors",
                        "lia.svm.q_entries", "lia.svm.dual_steps",
                        "lia.svm.dual_step_vectors", "lia.svm.support",
                        "lia.svm.h2d_bytes", "lia.svm.d2h_bytes",
                        "lia.svm.host_syncs"}
