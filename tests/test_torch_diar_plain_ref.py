"""The port's broadcast-news diarization path against the plain reference
of ``tests/plain_ref/diar_ehmm.py`` (float64, TF32 off, nothing of either
package): the stacked emissions, the batched MAP adaptation of state
rows (all-zero rows included), the CPU Viterbi decoder, and a whole
E-HMM segmentation then ReSegmentation.  Small sizes on the CPU (K=8,
D=6, N ≤ 3,000, S ≤ 4) with seeded random weights; each tolerance is
stated with its reason.  Also: the benchmark's copy of the reference is
the same text, and the reference loads neither the port nor JAX."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.gmm.model import GmmDiag
from lia_ral_tpu_torch.io.labels import segments_to_frame_mask
from lia_ral_tpu_torch.seg import diarization as tdz
from lia_ral_tpu_torch.seg import hmm as thmm

from plain_ref import diar_ehmm as ref

import _torch_parity  # noqa: F401  (two torch threads a test worker)

ROOT = Path(__file__).resolve().parent.parent
REF_FILE = ROOT / "tests" / "plain_ref" / "diar_ehmm.py"
BENCH_COPY = ROOT / "benchmark" / "reference" / "diar.py"
K, D, N, SPK, S = 8, 6, 3000, 4, 4
EHMM = dict(max_speakers=S, init_seg_frames=300, nb_decode_it=3,
            min_duration=50, map_reg=16.0)


def _world(rng):
    w = rng.random(K) + 0.5
    return ((w / w.sum()).astype(np.float32),
            rng.standard_normal((K, D)).astype(np.float32),
            (rng.random((K, D)) + 0.5).astype(np.float32))


def _bank(rng, s=S):
    ws, ms, vs = zip(*(_world(rng) for _ in range(s)))
    return np.stack(ws), np.stack(ms), np.stack(vs)


def _gmm(w, m, v) -> GmmDiag:
    return GmmDiag(torch.from_numpy(w), torch.from_numpy(m),
                   torch.from_numpy(1.0 / v))


def _f64(*arrays):
    return tuple(torch.from_numpy(np.asarray(a, np.float64)) for a in arrays)


def _show(seed, n=N, shift=1.0):
    """Frames of SPK speakers, each the world with its own mean shift (in
    σ units), in turns of 150-450 frames: (x (n, D), world)."""
    rng = np.random.default_rng(seed)
    w, m, v = _world(rng)
    off = rng.standard_normal((SPK, K, D)) * shift * np.sqrt(v)
    who, last = [], -1
    while len(who) < n:
        s = int(rng.integers(SPK))
        if s != last:
            who += [s] * int(rng.integers(150, 450))
            last = s
    who = np.asarray(who[:n])
    comp = rng.choice(K, n, p=w / w.sum())
    x = m[comp] + off[who, comp] + np.sqrt(v[comp]) * rng.standard_normal(
        (n, D))
    return x.astype(np.float32), (w, m, v)


def test_stacked_emissions_match_the_reference(rng):
    """The port's quadratic expansion in float32 against the float64
    reference: each term of a log-density is a few units here, so float32
    rounding over D terms stays under 1e-5 of the largest |emission|.
    Inactive states read −1e30 in both."""
    bank = _bank(rng)
    x = (rng.standard_normal((N, D)) * 1.5).astype(np.float32)
    stacked = GmmDiag(*(torch.from_numpy(a) for a in
                        (bank[0], bank[1], 1.0 / bank[2])))
    got = thmm.stacked_emission_llk(torch.from_numpy(x), stacked).numpy()
    want = ref.emissions(_f64(x)[0], _f64(*bank)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    active = np.array([True, False, True, False])
    got = tdz._masked_emissions(torch.from_numpy(x), stacked,
                                active).numpy()
    want = ref.emissions(_f64(x)[0], _f64(*bank),
                         torch.from_numpy(active)).numpy()
    assert (got[:, ~active] == ref.INACTIVE).all()
    assert (want[:, ~active] == ref.INACTIVE).all()
    np.testing.assert_allclose(got[:, active], want[:, active], rtol=0,
                               atol=1e-5 * np.abs(want[:, active]).max())


def test_batched_map_adaptation_matches_the_reference(rng):
    """One adapted state a mask row: every frame, a window of 300, a
    scattered half, and no frame at all.  The port's statistics are
    float32 sums over up to 3,000 frames (relative rounding ~1e-6 a
    component), moved through three MAP iterations: weights and means
    within 2e-5 of the reference's scale.  A row of zeros gives the world
    back, digit for digit; variances are never adapted."""
    w, m, v = _world(rng)
    x = (m[rng.integers(K, size=N)] + rng.standard_normal((N, D)) * 0.8
         ).astype(np.float32)
    masks = np.zeros((S, N), np.float32)
    masks[0] = 1.0
    masks[1, 1200:1500] = 1.0
    masks[2] = rng.random(N) < 0.5
    got = tdz._batched_state_adapt(torch.Generator(), torch.from_numpy(x),
                                   torch.from_numpy(masks), _gmm(w, m, v),
                                   map_reg=16.0)
    ww, wm, wv = ref.map_adapt(_f64(x)[0], _f64(masks)[0], _f64(w, m, v),
                               nb_it=3, reg=16.0)
    np.testing.assert_allclose(got.weights.numpy(), ww.numpy(), rtol=0,
                               atol=2e-5 * float(ww.max()))
    np.testing.assert_allclose(got.means.numpy(), wm.numpy(), rtol=0,
                               atol=2e-5 * float(wm.abs().max()))
    np.testing.assert_array_equal(got.weights[3].numpy(), w)
    np.testing.assert_array_equal(got.means[3].numpy(), m)
    np.testing.assert_array_equal(got.cov_inv.numpy(),
                                  np.broadcast_to(1.0 / v, (S, K, D)))
    np.testing.assert_array_equal(wv.numpy(),
                                  np.broadcast_to(v, (S, K, D)))


@pytest.mark.parametrize("kind", ["integers", "continuous"])
def test_cpu_viterbi_is_the_reference_decoder_in_float32(rng, kind):
    """Run in float32, the reference's loop is the port's CPU decoder op
    for op, so the paths are equal frame for frame, ties included
    (integer emissions tie often: the first index wins in both)."""
    if kind == "integers":
        em = rng.integers(-6, 1, size=(N, S)).astype(np.float32)
    else:
        em = (rng.standard_normal((N, S)) * 3).astype(np.float32)
    act = torch.tensor([True, True, True, False])
    lt = ref.log_transitions(S, act, torch.float32)
    got = thmm.viterbi_reference(torch.from_numpy(em), lt)
    states, _ = ref.viterbi(torch.from_numpy(em), lt)
    assert torch.equal(got, ref.port_labels(states))
    assert ref.port_labels(states).max() < 3


def test_cpu_viterbi_path_scores_best_in_float64(rng):
    """In float64 the reference's best path scores no better than the
    port's path (its first frame restored as the best start): a float32
    decoder's deltas reach ~3e4 here, so a decision can turn on rounding
    of ~2e-3 at most, far below 1e-6 nats a frame over the whole path."""
    em = (rng.standard_normal((N, S)) * 3).astype(np.float32)
    lt32 = ref.log_transitions(S, torch.ones(S, dtype=torch.bool),
                               torch.float32)
    path = thmm.viterbi_reference(torch.from_numpy(em), lt32)
    em64, lt64 = torch.from_numpy(em).double(), lt32.double()
    best, score = ref.viterbi(em64, lt64)
    mine = ref.states_of_labels(path, em64, lt64)
    assert torch.equal(ref.port_labels(mine), path)
    assert float(ref.path_score(em64, lt64, best)) == pytest.approx(
        float(score), rel=1e-12)
    gap = float(ref.path_score(em64, lt64, best)
                - ref.path_score(em64, lt64, mine)) / N
    assert 0.0 <= gap < 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_e_hmm_then_resegmentation_match_the_reference(seed):
    """The port's E-HMM (float32, the CPU's statistics path) and its
    ReSegmentation of the segments it writes, against the float64
    reference's loops from the same frames and world: the paths agree on
    ≥ 99.5 % of the frames (float32 emissions can move a boundary frame
    or a window's argmin on a near-tie) and the HMMs end with as many
    speakers; ReSegmentation reads the same masks from the E-HMM's
    segments as the reference derives from its labels."""
    x, world = _show(seed)
    segs, path = tdz.e_hmm_segmentation(x, _gmm(*world), **EHMM)
    names = sorted({sg.label for sg in segs})
    _, rpath = tdz.resegmentation(x, segs, _gmm(*world), nb_it=3,
                                  min_duration=50, min_state_frames=25,
                                  map_reg=16.0)
    x64, w64 = _f64(x)[0], _f64(*world)
    p_ref, active = ref.e_hmm(x64, w64, S, init_seg_frames=300,
                              nb_decode_it=3, reg=16.0)
    assert (p_ref.numpy() == path).mean() >= 0.995
    assert active == S == len(np.unique(path))
    masks, states = ref.reseg_masks(torch.from_numpy(path), 50)
    assert [f"S{s}" for s in states] == names
    want = np.stack([segments_to_frame_mask(
        [sg for sg in segs if sg.label == nm], N) for nm in names])
    np.testing.assert_array_equal(masks.numpy() > 0, want)
    masks, _ = ref.reseg_masks(p_ref, 50)
    r_ref, left = ref.resegmentation(x64, masks, w64, nb_it=3,
                                     min_state_frames=25, reg=16.0)
    assert (r_ref.numpy() == rpath).mean() >= 0.995
    assert left == len(np.unique(rpath)) == len(np.unique(r_ref.numpy()))


def test_the_benchmark_copy_is_the_same_text():
    assert BENCH_COPY.read_text() == REF_FILE.read_text()


def test_the_reference_loads_neither_the_port_nor_jax():
    """By its import statements and by what importing it loads; it sets
    TF32 off and computes in the dtype it is given (float64 here)."""
    tree = ast.parse(REF_FILE.read_text())
    imported = {a.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names}
    imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
    assert imported <= {"__future__", "math", "torch"}
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REF_FILE.parent.parent)!r})\n"
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "from plain_ref import diar_ehmm as ref\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "x = torch.randn(50, 3, dtype=torch.float64)\n"
        "bank = (torch.full((2, 4), 0.25, dtype=torch.float64),\n"
        "        torch.randn(2, 4, 3, dtype=torch.float64),\n"
        "        torch.ones(2, 4, 3, dtype=torch.float64))\n"
        "assert ref.emissions(x, bank).dtype == torch.float64\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = proc.stdout.strip().splitlines()[-1]
    for name in ("jax", "jaxlib", "lia_ral_tpu", "lia_ral_tpu_torch"):
        assert f"'{name}'" not in tops
