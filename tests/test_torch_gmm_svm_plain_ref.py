"""The port's GMM-supervector SVM with NAP against the plain reference of
``tests/plain_ref/gmm_svm_nap.py`` (float64, TF32 off, nothing of either
package): the tools' chain ``adapt_model`` → ``get_supervector("KL")`` →
``train_nap_subspace`` → ``nap_project_vectors`` → ``svm_train`` →
``SvmModel.decision`` at a small size on the CPU (K=16, D=6, 20
background speakers × 3 sides, NAP rank 2, 2 targets, 4 test sides),
read by the four numbers the benchmark's cell compares; the repaired
linear ``svm_train`` on raw supervector-like vectors with a large common
part at N = 1,000, where 500 FISTA steps on the untranslated vectors miss
the optimum; the reference's SMO against the SMO of
``tests/test_svm_parity.py``.  Each tolerance is stated with its reason.
Also: the benchmark's copy of the reference is the same text, and the
reference loads neither the port nor JAX."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.backend import supervector as tsv
from lia_ral_tpu_torch.backend import svm as tsvm
from lia_ral_tpu_torch.gmm.map_adapt import MapCfg, adapt_model
from lia_ral_tpu_torch.gmm.model import GmmDiag

from plain_ref import gmm_svm_nap as ref

import _torch_parity  # noqa: F401  (two torch threads a test worker)

ROOT = Path(__file__).resolve().parent.parent
REF_FILE = ROOT / "tests" / "plain_ref" / "gmm_svm_nap.py"
BENCH_COPY = ROOT / "benchmark" / "reference" / "svm.py"
K, D, T = 16, 6, 400
BG_SPK, SESS, RANK, TARGETS, OTHERS = 20, 3, 2, 2, 2


def _world(rng):
    w = rng.random(K) + 0.5
    return ((w / w.sum()).astype(np.float32),
            (rng.standard_normal((K, D)) * 1.15).astype(np.float32),
            (rng.random((K, D)) + 0.5).astype(np.float32))


def _sides(rng, world, n_spk, sessions, chan):
    """Frames of ``sessions`` sides of each of ``n_spk`` speakers: the
    world's means moved by 0.3 σ a speaker and a point of the channel
    subspace a side."""
    ww, wm, wv = world
    out = []
    for _ in range(n_spk):
        spk = rng.standard_normal((K, D)) * 0.3
        for _ in range(sessions):
            off = (spk + (rng.standard_normal(RANK) @ chan).reshape(K, D)) \
                * np.sqrt(wv)
            comp = rng.choice(K, T, p=ww / ww.sum())
            x = (wm + off)[comp] + np.sqrt(wv)[comp] \
                * rng.standard_normal((T, D))
            out.append(x.astype(np.float32))
    return out


def _case(seed=5):
    rng = np.random.default_rng(seed)
    world = _world(rng)
    chan = rng.standard_normal((RANK, K * D)) * (0.3 / RANK ** 0.5)
    bg = _sides(rng, world, BG_SPK, SESS, chan)
    # each target's enrolment side, then the test sides: the targets'
    # second sides, then one side of each other speaker
    tg = _sides(rng, world, TARGETS, 2, chan)
    others = _sides(rng, world, OTHERS, 1, chan)
    sides = tg[0::2] + tg[1::2] + others
    return world, bg, sides


def _port(world, bg, sides):
    """The tools' chain in the port: NAP subspace, projected supervectors
    of ``sides``, primal weights and biases of the targets' SVMs, scores."""
    ww, wm, wv = (torch.from_numpy(a) for a in world)
    gmm = GmmDiag(weights=ww, means=wm, cov_inv=1.0 / wv)
    cfg = MapCfg(method="MAPOccDep", mean_adapt=True, mean_r=16.0,
                 nb_train_it=1)
    gen = torch.Generator().manual_seed(0)

    def kl(x):
        x = torch.from_numpy(x)
        client = adapt_model(gen, x, torch.ones(x.shape[0]), gmm, cfg)
        return tsv.get_supervector("KL", gmm, client)

    bgv = torch.stack([kl(x) for x in bg])
    spk = torch.arange(BG_SPK).repeat_interleave(SESS)
    u = tsv.train_nap_subspace(bgv, spk, BG_SPK, RANK)
    bgv = tsv.nap_project_vectors(bgv, u)
    svs = torch.stack([tsv.nap_project_vectors(kl(x)[None], u)[0]
                       for x in sides])
    y = np.r_[1.0, -np.ones(len(bg))].astype(np.float32)
    models = [tsvm.svm_train(torch.cat([svs[i:i + 1], bgv]), y)
              for i in range(TARGETS)]
    w = torch.stack([torch.from_numpy(m.alpha_y).double()
                     @ torch.from_numpy(m.support).double() for m in models])
    scores = torch.stack([m.decision(svs[TARGETS:]) for m in models])
    return u.double(), svs.double(), w, scores.double()


def _reference(world, bg, sides):
    w64 = tuple(torch.from_numpy(a).double() for a in world)

    def kl(xs):
        x = torch.stack([torch.from_numpy(a).double() for a in xs])
        return ref.kl_supervectors(ref.map_means(x, w64, 16.0), w64)

    bgv = kl(bg)
    u = ref.nap_subspace(bgv, torch.arange(BG_SPK).repeat_interleave(SESS),
                         RANK)
    bgv = ref.nap_project(bgv, u)
    svs = ref.nap_project(kl(sides), u)
    w, b, _, _ = ref.svm_train(svs[:TARGETS], bgv)
    return u, svs, w, ref.scores(w, b, svs[TARGETS:])


@pytest.fixture(scope="module")
def chain():
    world, bg, sides = _case()
    return _port(world, bg, sides), _reference(world, bg, sides)


def test_nap_subspace_matches_the_reference(chain):
    """Sine of the largest principal angle ≤ 2e-5 (read 8.4e-7): the
    port's float32 SVD of the speaker-centred matrix and its float32
    supervectors against the float64 eigenvectors of the dual Gram; the
    two channel directions stand far above the within-speaker noise, so
    rounding of order 1e-6 of the vectors moves the subspace by about
    that much."""
    (u, _, _, _), (ur, _, _, _) = chain
    assert u.shape == ur.shape == (RANK, K * D)
    angle = float(torch.linalg.matrix_norm(u - (u @ ur.T) @ ur, ord=2))
    assert angle <= 2e-5, angle


def test_projected_supervectors_match_the_reference(chain):
    """max ‖Δs‖/‖s_ref‖ ≤ 5e-6 (read 3.7e-7): MAP's f32 statistics on
    the CPU (the f32 stats path that the default tier takes there) and
    the f32 KL scaling, against float64: a few float32 roundings of each
    entry."""
    (_, svs, _, _), (_, svr, _, _) = chain
    gap = float(((svs - svr).norm(dim=1) / svr.norm(dim=1)).max())
    assert gap <= 5e-6, gap


def test_svm_weights_and_scores_match_the_reference(chain):
    """max ‖Δw‖/‖w_ref‖ ≤ 2e-4 (read 1.2e-5) and max |Δscore| /
    std(scores_ref) ≤ 2e-3 (read 9.6e-5): the port's 500 float32 FISTA
    steps on the translated vectors against SMO at a violation of 1e-9;
    w is the C-SVC's unique primal optimum, the scores its decisions
    (their spread over 4 test sides is small, so the second budget is
    the wider)."""
    (_, _, w, scores), (_, _, wr, sr) = chain
    w_gap = float(((w - wr).norm(dim=1) / wr.norm(dim=1)).max())
    assert w_gap <= 2e-4, w_gap
    score_gap = float((scores - sr).abs().max() / sr.std())
    assert score_gap <= 2e-3, score_gap
    # each target's own second side scores above every other test side
    assert all(int(sr[i].argmax()) == i for i in range(TARGETS))
    assert all(int(scores[i].argmax()) == i for i in range(TARGETS))


def _raw_problem(seed, n_spk=333, d=2000, rel=0.05, rank=16):
    """Supervector-like vectors: a shared mean and speaker and rank-16
    channel offsets of ``rel`` of its norm; one target's side against the
    sides of the other speakers (N = 997)."""
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(d, generator=g)
    s = rel / 2 ** 0.5
    spk = torch.randn(n_spk, d, generator=g) * s
    u = torch.randn(rank, d, generator=g) * (s / rank ** 0.5)
    x = (m + spk.repeat_interleave(3, 0)
         + torch.randn(3 * n_spk, rank, generator=g) @ u)
    return torch.cat([x[1:2], x[3:]])


def test_svm_train_reaches_the_optimum_on_raw_supervector_like_vectors():
    """500 FISTA steps on the raw vectors leave w 10 % or more from the
    optimum (the step 1/λ_max is set by the common part, which the
    constraint yᵀα = 0 takes out of the problem); the repaired linear
    svm_train, on the vectors less their mean, gives w within 1e-3 of
    SMO's (the f32 solve on a problem some 10² times better conditioned),
    keeps the raw support vectors, and scores within 1e-2 of the score
    spread."""
    torch.set_num_threads(2)
    x = _raw_problem(3)
    n = x.shape[0]
    y = np.r_[1.0, -np.ones(n - 1)].astype(np.float32)
    w_ref, b_ref, _, _ = ref.svm_train(x[:1].double(), x[1:].double())
    c = tsvm.default_c(x.numpy())
    a_raw = tsvm.dual_solve_reference(tsvm.kernel_matrix(x, x),
                                      torch.from_numpy(y),
                                      torch.full((n,), c))
    w_raw = (a_raw.double() * torch.from_numpy(y).double()) @ x.double()
    assert float((w_raw - w_ref[0]).norm() / w_ref[0].norm()) > 0.1
    model = tsvm.svm_train(x, y)
    w = torch.from_numpy(model.alpha_y).double() \
        @ torch.from_numpy(model.support).double()
    assert float((w - w_ref[0]).norm() / w_ref[0].norm()) <= 1e-3
    assert all(any(np.array_equal(s, r) for r in x.numpy())
               for s in model.support[:5])
    test = x[:100]
    want = test.double() @ w_ref[0] + b_ref[0]
    got = model.decision(test).double()
    assert float((got - want).abs().max() / want.std()) <= 1e-2


@pytest.mark.parametrize("n_tgt,n_coh,d", [(1, 60, 40), (3, 60, 40),
                                           (2, 30, 500)])
def test_reference_smo_matches_the_parity_suites_smo(n_tgt, n_coh, d):
    """The reference's batched SMO (libsvm's WSS 2 and two-variable update)
    and the JAX parity suite's numpy SMO reach the same dual optimum:
    objectives within 1e-9 relative and decisions within 1e-6 of their
    scale, both stopped at a violation of 1e-10."""
    from test_svm_parity import dual_objective, smo_reference

    rng = np.random.default_rng(n_tgt + d)
    x = np.vstack([rng.standard_normal((n_tgt, d)) * 0.3 + 1.2,
                   rng.standard_normal((n_coh, d))])
    y = np.r_[np.ones(n_tgt), -np.ones(n_coh)]
    k = x @ x.T
    c = np.full(y.shape, 1.0 / np.mean(np.sum(x * x, 1)))
    a_np, b_np = smo_reference(k, y, c, tol=1e-10)
    kt, yt = torch.from_numpy(k), torch.from_numpy(y)
    a, rho, _ = ref.smo((kt * (yt[:, None] * yt[None]))[None], yt[None],
                        torch.from_numpy(c)[None], eps=1e-10)
    a = a[0].numpy()
    obj, obj_np = dual_objective(k, y, a), dual_objective(k, y, a_np)
    assert abs(obj - obj_np) <= 1e-9 * abs(obj_np)
    dec, dec_np = k @ (a * y) - float(rho[0]), k @ (a_np * y) + b_np
    assert np.abs(dec - dec_np).max() <= 1e-6 * np.abs(dec_np).max()
    assert (a >= 0).all() and (a <= c).all() and abs(a @ y) <= 1e-12


def test_reference_copy_in_the_benchmark_is_the_same_text():
    assert BENCH_COPY.read_text() == REF_FILE.read_text()


def test_reference_imports_neither_the_port_nor_jax():
    tree = ast.parse(REF_FILE.read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "math", "torch"}, names
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            "from plain_ref import gmm_svm_nap\n"
            "print(sorted(m.split('.')[0] for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    for name in ("jax", "jaxlib", "lia_ral_tpu", "lia_ral_tpu_torch"):
        assert f"'{name}'" not in out
