"""``backend.svm.svm_train``'s model against the host formulas of
``tests/_svm_host_model.py`` applied to the same solve's α and kernel
matrix (linear, poly, rbf; a target penalty; a problem whose α all lie
at C, so that the bias comes from every vector): the same support set,
α·y and bias within float64 rounding, C within float32 rounding of
``default_c``; one host read a solve; and the SvmTrain tool writing and
keeping numpy arrays from a model whose rows are tensors, as a card's
are.
Small sizes on the CPU, few FISTA steps."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.backend import svm as tsvm
from lia_ral_tpu_torch.config import Config
from lia_ral_tpu_torch.io.lists import write_xlist
from lia_ral_tpu_torch.io.matrix import write_matrix_file
from lia_ral_tpu_torch.tools import utils_tools as tut
from lia_ral_tpu_torch.utils import logging as tlog

import _torch_parity  # noqa: F401  (two torch threads a test worker)
from _svm_host_model import default_c64, host_model

D, STEPS = 16, 60


def _problem(seed, n_tgt, n_coh, spread=1.0):
    """Targets shifted from a cohort, both on a common offset (which the
    linear kernel's translation and −w·m carry)."""
    rng = np.random.default_rng(seed)
    x = spread * rng.standard_normal((n_tgt + n_coh, D)) + 3.0
    x[:n_tgt] += 0.8
    y = np.r_[np.ones(n_tgt), -np.ones(n_coh)]
    return x.astype(np.float32), y.astype(np.float32)


def _solved(monkeypatch):
    """Record each solve's K, y, bounds and α as svm_train makes them."""
    seen = []
    inner = tsvm._dual_solve

    def recorded(k, y, c_vec, n_iter=500):
        alpha = inner(k, y, c_vec, n_iter)
        seen.append(tuple(t.detach().cpu().numpy().copy()
                          for t in (k, y, c_vec, alpha)))
        return alpha
    monkeypatch.setattr(tsvm, "_dual_solve", recorded)
    return seen


CASES = {
    "linear": dict(problem=(1, 4, 36), kw={}),
    "linear_tensor_input": dict(problem=(2, 6, 30), kw={}, tensor=True),
    # C's and x·m's float64 sums three rows a block, the last one short
    "linear_blocks": dict(problem=(8, 4, 36), kw={}, block=3 * D + 1),
    "linear_penalty": dict(problem=(3, 3, 40), kw={"target_penalty": 10.0}),
    "poly": dict(problem=(4, 5, 30), kw={"kind": "poly", "degree": 2}),
    "rbf": dict(problem=(5, 5, 30), kw={"kind": "rbf", "gamma": 0.05}),
    "rbf_penalty": dict(problem=(6, 4, 30),
                        kw={"kind": "rbf", "target_penalty": 3.0}),
    # balanced classes under a C far below the margin's α: every α ends
    # at C, no vector is free, the bias is the mean over all of them
    "no_margin": dict(problem=(7, 8, 8, 3.0), kw={"c": 1e-5}),
}


@pytest.mark.parametrize("case", CASES)
def test_svm_train_model_equals_the_host_formulas(case, monkeypatch):
    spec = CASES[case]
    x, y = _problem(*spec["problem"])
    seen = _solved(monkeypatch)
    if "block" in spec:
        monkeypatch.setattr(tsvm, "F64_BLOCK", spec["block"])
    xin = torch.from_numpy(x) if spec.get("tensor") else x
    model = tsvm.svm_train(xin, y, n_iter=STEPS, **spec["kw"])
    (k, ys, c_vec, alpha), = seen
    np.testing.assert_array_equal(ys, y)
    kw = spec["kw"]
    c = kw.get("c", default_c64(x))
    if "c" not in kw:
        assert abs(c - tsvm.default_c(x)) <= 1e-6 * c
    want_c = np.full(len(y), c, np.float32)
    want_c[y > 0] *= kw.get("target_penalty", 1.0)
    np.testing.assert_array_equal(c_vec, want_c)
    centre = (torch.from_numpy(x).mean(dim=0).numpy()
              if kw.get("kind", "linear") == "linear" else None)
    support, alpha_y, bias, margin = host_model(x, y, alpha, k, c_vec, c,
                                                centre)
    if case == "no_margin":
        assert margin == 0 and len(support) == len(y)
    else:
        assert 0 < margin < len(support) <= len(y)
    for got in (model.support, model.alpha_y):
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(model.support, support)
    np.testing.assert_allclose(model.alpha_y, alpha_y, rtol=1e-12, atol=0)
    scale = 1.0 + np.abs(k).max() * np.abs(alpha_y).sum() + (
        0.0 if centre is None
        else np.abs(alpha_y).sum() * np.abs(x).max() * np.abs(centre).sum())
    assert abs(model.bias - bias) <= 1e-13 * scale, (model.bias, bias)
    assert isinstance(model.bias, float)


@pytest.mark.parametrize("kind", ["linear", "rbf"])
def test_svm_train_reads_the_host_once_a_solve(kind, tmp_path, monkeypatch):
    """``lia.svm.host_syncs`` equals the reads of a tensor's values into
    Python that the calls made (each counted apart): one a solve, none
    in a decision of the model on its own device; off the card nothing
    crosses between host and card."""
    problems = [_problem(s, 3, 20) for s in (11, 12)]
    reads = []
    patched = {}
    for name in ("tolist", "item", "__bool__", "__float__", "__int__"):
        inner = getattr(torch.Tensor, name)

        def counted(t, *a, _inner=inner, **kw):
            reads.append(1)
            return _inner(t, *a, **kw)
        patched[name] = counted
    with tlog.profile_trace(str(tmp_path / "tr")):
        for name, fn in patched.items():
            monkeypatch.setattr(torch.Tensor, name, fn)
        for x, y in problems:
            model = tsvm.svm_train(torch.from_numpy(x), y, kind=kind,
                                   n_iter=STEPS)
            model.decision(torch.from_numpy(x[:4]))
        monkeypatch.undo()
    counted = json.loads((tmp_path / "tr" / "counters.json").read_text())
    assert counted["lia.svm.solves"] == len(problems)
    assert counted["lia.svm.host_syncs"] == len(reads) == len(problems)
    assert counted["lia.svm.h2d_bytes"] == counted["lia.svm.d2h_bytes"] == 0


class _CardRows(torch.Tensor):
    """A tensor numpy cannot take as it stands, as a card's cannot."""

    def __array__(self, *args, **kwargs):
        raise TypeError("a card's tensor is not a host array")


def test_svm_train_tool_writes_numpy_arrays_from_a_card_model(tmp_path,
                                                              monkeypatch):
    """svmTrain reads a model's support rows and α·y to the host at save
    time: its ``.svm.npz`` holds numpy float32 arrays equal to the
    model's, the models it returns hold those host arrays and not the
    card's rows, and the file loads back to the same decisions."""
    x, _ = _problem(21, 2, 12)
    d = str(tmp_path)
    names = [f"v{i}" for i in range(len(x))]
    for n, v in zip(names, x):
        write_matrix_file(os.path.join(d, n + ".vect"), v[None, :])
    write_xlist(os.path.join(d, "bg.lst"), [[n] for n in names[2:]])
    write_xlist(os.path.join(d, "targets.ndx"), [["t0", "v0", "v1"]])
    inner = tut.svm_train
    trained = []

    def card_like(*a, **kw):
        m = inner(*a, **kw)
        m.support = torch.as_tensor(m.support).as_subclass(_CardRows)
        m.alpha_y = torch.as_tensor(m.alpha_y).as_subclass(_CardRows)
        trained.append(m)
        return m
    monkeypatch.setattr(tut, "svm_train", card_like)
    with pytest.raises(TypeError):
        np.asarray(card_like(torch.from_numpy(x), np.r_[1.0, -np.ones(
            len(x) - 1)].astype(np.float32), n_iter=STEPS).support)
    trained.clear()
    models = tut.svm_train_main(Config({
        "torchDevice": "cpu", "vectorFilesPath": d + "/",
        "backgroundList": os.path.join(d, "bg.lst"),
        "targetIdList": os.path.join(d, "targets.ndx")}))
    z = np.load(os.path.join(d, "t0.svm.npz"))
    for key in ("support", "alpha_y"):
        assert type(z[key]) is np.ndarray and z[key].dtype == np.float32
        np.testing.assert_array_equal(
            z[key], getattr(trained[0], key).as_subclass(
                torch.Tensor).numpy())
        # the tool keeps the host copy, not the card's rows
        assert type(getattr(models["t0"], key)) is np.ndarray
        np.testing.assert_array_equal(getattr(models["t0"], key), z[key])
    loaded = tut.load_svm_model(os.path.join(d, "t0.svm.npz"))
    assert loaded.bias == models["t0"].bias == trained[0].bias
    probe = torch.from_numpy(x[:5])
    assert torch.equal(loaded.decision(probe),
                       trained[0].decision(probe).as_subclass(torch.Tensor))
