"""The port's total-variability training against the plain reference of
``tests/plain_ref/tv_em.py`` (float64, TF32 off, nothing of either
package), on seeded random statistics at a small size on the CPU: K=16,
D=6, R=8, 70 sessions with ``chunk`` 16, so that the last chunk holds 6
sessions and 10 of padding, and one session without a frame.  Held:
``tv_e_step``'s i-vectors and accumulators, ``tv_m_step`` and
``min_divergence`` on the reference's own accumulators, and two chained
``tv_em_iteration`` calls against two chained reference iterations.
Each tolerance is stated with its reason; a float16 cast of E_c fails
them.  Also: the reference's accumulators against the scalar loop of
``tests/test_tv.py``, the benchmark's copy of the reference is the same
text, and the reference loads neither the port nor JAX."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.fa import tv as ttv
from lia_ral_tpu_torch.fa.stats import BwStats

from plain_ref import tv_em as ref

import _torch_parity  # noqa: F401  (two torch threads a test worker)

ROOT = Path(__file__).resolve().parent.parent
REF_FILE = ROOT / "tests" / "plain_ref" / "tv_em.py"
BENCH_COPY = ROOT / "benchmark" / "reference" / "tv_em.py"
K, D, R, S, CHUNK, FRAMES = 16, 6, 8, 70, 16, 300
EMPTY = 37                      # the session without a frame

# float32 against float64 on statistics of 300 frames a session: each
# sum of the E-step rounds a few times at 6e-8 of its size, and L and
# A_c (condition numbers up to 3.3 and 4.0 here) pass that on; T, the
# means and w read 5e-8 to 6.4e-7, so 2e-5 leaves 30x above them, while
# a float16 E_c (2.4e-4 a rounding) reads 8e-5 to 2.7e-4 on T and w
TOL_REL = 2e-5
# the accumulators are sums of positive terms and of products of w (read
# 1.9e-7 to 2.6e-7 against their largest entry): the same budget
TOL_ACC = 2e-5


def _problem(seed=11):
    """A UBM's (weights, means, variances), (N, F) of S sessions (session
    ``EMPTY`` without a frame), and T of the size EM reaches (shifts of
    0.5 σ), all float32 tensors."""
    rng = np.random.default_rng(seed)
    ww = rng.random(K) + 0.5
    ww /= ww.sum()
    wm = rng.standard_normal((K, D)) * 0.5
    wv = rng.random((K, D)) + 0.5
    t = rng.standard_normal((R, K, D)) * (0.5 / R ** 0.5) * np.sqrt(wv)
    occ = ww * (0.5 + rng.random((S, K)))
    n = FRAMES * occ / occ.sum(1, keepdims=True)
    shift = (rng.standard_normal((S, R)) @ t.reshape(R, -1)).reshape(S, K, D)
    f = (n[..., None] * (wm + shift)
         + np.sqrt(n)[..., None] * np.sqrt(wv)
         * rng.standard_normal((S, K, D)))
    n[EMPTY], f[EMPTY] = 0.0, 0.0

    def t32(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    return (t32(ww), t32(wm), t32(wv)), BwStats(n=t32(n), f=t32(f)), t32(t)


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _model(world, t):
    return ttv.TvModel(t=t, ubm_means=world[1], ubm_inv_var=1.0 / world[2])


def _rel(got, want, axis=None) -> float:
    """Largest relative gap: over rows of ``axis`` (norms of the rest), or
    of the whole array against its largest entry."""
    got, want = got.double(), want.double()
    if axis is None:
        return float((got - want).abs().max() / want.abs().max())
    dims = tuple(i for i in range(want.dim()) if i != axis)
    gap = (got - want).square().sum(dims).sqrt()
    return float((gap / want.square().sum(dims).sqrt()).max())


def _acc64(world, stats, t):
    return ref.accumulate(stats.n.double(), stats.f.double(), t.double(),
                          world[1].double(), world[2].double(), block=CHUNK)


def test_e_step_matches_the_reference(problem):
    """w per session and A, C, Σ E[wwᵀ], Σ w, S within TOL_REL / TOL_ACC;
    the padded last chunk adds nothing and the empty session counts."""
    world, stats, t = problem
    w, acc = ttv.tv_e_step(stats, _model(world, t), chunk=CHUNK)
    want = _acc64(world, stats, t)
    keep = torch.arange(S) != EMPTY
    assert _rel(w[keep], want["w"][keep], axis=0) <= TOL_REL
    assert _rel(acc.a, want["a"]) <= TOL_ACC
    assert _rel(acc.c.permute(1, 0, 2), want["c"]) <= TOL_ACC
    assert _rel(acc.r_mat, want["r_mat"]) <= TOL_ACC
    assert _rel(acc.r_vec, want["r_vec"]) <= TOL_ACC
    assert float(acc.n_utts) == want["sessions"] == S


def test_session_without_frames_has_the_prior(problem):
    """n = 0: L = I, so w = 0 exactly in both, and L⁻¹ = I counts in
    Σ E[wwᵀ] as the reference's loop over the session list counts it."""
    world, stats, t = problem
    w, acc = ttv.tv_e_step(stats, _model(world, t), chunk=CHUNK)
    assert torch.count_nonzero(w[EMPTY]) == 0
    one = BwStats(n=stats.n[EMPTY:EMPTY + 1], f=stats.f[EMPTY:EMPTY + 1])
    w1, acc1 = ttv.tv_e_step(one, _model(world, t), chunk=CHUNK)
    assert torch.count_nonzero(w1) == 0
    assert torch.equal(acc1.r_mat, torch.eye(R))
    want = _acc64(world, one, t)
    assert torch.equal(want["r_mat"], torch.eye(R, dtype=torch.float64))
    assert torch.count_nonzero(want["a"]) == 0


def test_m_step_and_min_divergence_match_the_reference(problem):
    """On the reference's accumulators rounded to float32: T_c = A_c⁻¹C_c
    within TOL_REL of each component's norm (A_c's condition number is
    small here: each A_c sums 70 sessions' E[wwᵀ] of rank R = 8), and the
    minimum divergence's T and means within TOL_REL (σ units for the
    means)."""
    world, stats, t = problem
    want = _acc64(world, stats, t)
    acc = ttv.TvAccums(a=want["a"].float(),
                       c=want["c"].permute(1, 0, 2).float(),
                       r_mat=want["r_mat"].float(),
                       r_vec=want["r_vec"].float(),
                       n_utts=torch.tensor(float(want["sessions"])))
    model = _model(world, t)
    t_ref = ref.m_step(want)
    got = ttv.tv_m_step(model, acc)
    assert _rel(got.t, t_ref, axis=1) <= TOL_REL
    t_div, m_div = ref.min_divergence(t_ref, world[1].double(), want)
    got = ttv.min_divergence(got, acc)
    assert _rel(got.t, t_div, axis=1) <= TOL_REL
    sigma = world[2].double().sqrt()
    assert float(((got.ubm_means - m_div).abs() / sigma).max()) <= TOL_REL


def _chained(world, stats, t, iterations=2):
    """(port's, reference's) (T, means, w) after each of ``iterations``
    chained EM iterations with minimum divergence, each side from its own
    last model."""
    model = _model(world, t)
    t64, m64, v64 = t.double(), world[1].double(), world[2].double()
    out = []
    for _ in range(iterations):
        model, w = ttv.tv_em_iteration(stats, model, chunk=CHUNK,
                                       min_div=True)
        t64, m64, w64 = ref.em_iteration(stats.n.double(), stats.f.double(),
                                         t64, m64, v64, block=CHUNK)
        out.append(((model.t, model.ubm_means, w), (t64, m64, w64)))
    return out


def _gaps(world, got, want):
    keep = torch.arange(S) != EMPTY
    sigma = world[2].double().sqrt()
    return (_rel(got[0], want[0], axis=1),
            float(((got[1].double() - want[1]).abs() / sigma).max()),
            _rel(got[2][keep], want[2][keep], axis=0))


def test_two_chained_em_iterations_match_the_reference(problem):
    """T per component, the means in σ units and w per session within
    TOL_REL after each of two chained iterations: the second starts from
    each side's own first result, so the first's rounding carries into
    it, damped by EM's contraction."""
    world, stats, t = problem
    for got, want in _chained(world, stats, t):
        assert max(_gaps(world, got, want)) <= TOL_REL, _gaps(world, got,
                                                              want)
        assert torch.count_nonzero(got[2][EMPTY]) == 0


def test_a_float16_e_c_fails_the_tolerances(problem, monkeypatch):
    """The same chained run with E_c rounded to float16 (11 significant
    bits) leaves T and w past TOL_REL: the tolerances see a lower
    precision than the port's."""
    world, stats, t = problem
    inner = ttv.estimate_tett
    monkeypatch.setattr(ttv, "estimate_tett",
                        lambda model: inner(model).half().float())
    worst = [_gaps(world, got, want)
             for got, want in _chained(world, stats, t)]
    assert max(g[0] for g in worst) > TOL_REL, worst
    assert max(g[2] for g in worst) > TOL_REL, worst


def test_reference_accumulators_equal_the_scalar_loop():
    """The reference's block-wise accumulators equal the scalar loop over
    sessions and components of ``tests/test_tv.py`` (an independent
    transcription of estimateAandC) to float64 rounding."""
    from test_tv import naive_e_step

    world, stats, t = _problem(seed=4)
    n, f = stats.n.double().numpy(), stats.f.double().numpy()
    ws, a, cm, r_mat, r_vec = naive_e_step(
        n, f, t.double().numpy(), world[1].double().numpy(),
        1.0 / world[2].double().numpy())
    want = _acc64(world, stats, t)
    for got, loop in ((want["w"], ws), (want["a"], a),
                      (want["c"].permute(1, 0, 2), cm),
                      (want["r_mat"], r_mat), (want["r_vec"], r_vec)):
        np.testing.assert_allclose(got.numpy(), loop, rtol=1e-10,
                                   atol=1e-10 * np.abs(loop).max())


def test_reference_copy_in_the_benchmark_is_the_same_text():
    assert BENCH_COPY.read_text() == REF_FILE.read_text()


def test_reference_imports_neither_the_port_nor_jax():
    tree = ast.parse(REF_FILE.read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "torch"}, names
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            "from plain_ref import tv_em\n"
            "print(sorted(m.split('.')[0] for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    for name in ("jax", "jaxlib", "lia_ral_tpu", "lia_ral_tpu_torch"):
        assert f"'{name}'" not in out
