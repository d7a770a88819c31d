"""The CUDA kernels K1 (em_stats_fused), K2 (bw_stats_fused), the
Viterbi decoder and the SVM dual solver of the PyTorch port against their
plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device.  This file imports neither jax nor the JAX package, so it also
runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX's CPU platform.)

Tolerances: the JAX suite's CPU budgets (tests/test_pallas_kernel.py
:35-46) with the atol scaled by the array's max — n rtol 1e-4, atol
1e-4·max n; sums rtol 1e-3, atol 1e-3·max|·| — since K=2048 sums over
tens of thousands of frames are O(10³); llk rel 1e-5.  The default tier
runs both products as three bf16 passes, as its plain version does, and
is also held against float64 (n and sums 1e-3·max|·|: the dropped lo·lo
terms and the bf16 rounding of lo leave ~2⁻¹⁷ per product term).  Every
other tier's stats product is one bf16 pass (fastStats by its key,
fastMath as the TPU's matrix unit runs an f32 product), so its S/F
budget is 2e-3·max|·| (a bf16 rounding of p or xa·s flips on an
f32-level difference between the kernel's and the plain version's
logits).  fastMath alone takes its occupancy from that product's column
and gets the same budget for n.  A tier's kernel must
also sit closer to its own plain version than to the default tier's, so
that rounding at other points would show.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch import _build
from lia_ral_tpu_torch.backend.svm import RESIDENT_LIMIT
from lia_ral_tpu_torch.convert import gmm_from_numpy
from lia_ral_tpu_torch.gmm import cuda_kernels as ck
from lia_ral_tpu_torch.gmm.kernels import EmStats
from lia_ral_tpu_torch.seg.hmm import compute_transitions

from _torch_parity import cuda_device, np_of, random_gmm_np

pytestmark = pytest.mark.cuda


def _gmm(seed, k, d, device):
    return gmm_from_numpy(*random_gmm_np(np.random.default_rng(seed), k, d),
                          device=device)


def _close(got, want, rtol):
    got, want = np_of(got), np_of(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


def _weights(rng, n, kind):
    """Frame weights as K1's callers give them: "random" in [0, 1) with
    ~5 % exact zeros (label masks); "mask" 0/1 in runs of 2-8 s with a
    third of the frames on (one speaker state of a diarization HMM);
    "zero" all zero (a state that lost every frame)."""
    if kind == "random":
        w = rng.random(n).astype(np.float32)
        w[rng.random(n) < 0.05] = 0.0
        return w
    w = np.zeros(n, np.float32)
    pos = 0
    while kind == "mask" and pos < n:
        run = int(rng.integers(200, 800))
        w[pos:pos + run] = float(rng.random() < 1 / 3)
        pos += run
    return w


def _k1_shapes(shapes):
    """(n, k, d, chunk, weights) cases, named n-k-d-chunk and, where the
    weights are not "random", their kind."""
    return [pytest.param(*c, id="-".join(map(str, c[:4]))
                         + ("" if c[4] == "random" else f"-{c[4]}"))
            for c in shapes]


# the shapes the main paths give K1 beyond the UBM's, the energy VAD's
# (K=3, D=1) and a MAP client's (10,000 frames): 1M frames (the library
# slice's), a diarization state's MAP (the speech frames against the
# K=128, D=24 world, under a 0/1 state mask and under an all-zero one),
# an event model's (K=32, D=24), the audio path's (K=128, D=40)
K1_PATH_SHAPES = [(1_000_000, 2048, 39, None, "random"),
                  (24000, 128, 24, None, "mask"),
                  (24000, 128, 24, None, "zero"),
                  (6000, 32, 24, None, "random"),
                  (2048, 128, 40, None, "random")]


def _check_k1(got, want, kw, weights, xt, wt, tg, other_kw):
    """``got`` against ``want`` within the arithmetic's budgets; all-zero
    weights give all-zero stats, other weights a kernel closer to its own
    plain version than to that of ``other_kw``'s arithmetic."""
    _close(got.n, want.n, _tier_n_rtol(kw))
    _close(got.sum_x, want.sum_x, _tier_sum_rtol(kw))
    _close(got.sum_xx, want.sum_xx, _tier_sum_rtol(kw))
    np.testing.assert_allclose(float(got.llk), float(want.llk), rtol=1e-5)
    np.testing.assert_allclose(float(got.count), float(want.count),
                               rtol=1e-6)
    if weights == "zero":
        for t in (got.n, got.sum_x, got.sum_xx, got.llk):
            assert torch.all(t == 0)
    elif other_kw is not None:
        _closer_to_tier(got.sum_x, want.sum_x,
                        ck.em_stats_reference(xt, wt, tg, **other_kw).sum_x)


@pytest.mark.parametrize("n,k,d,chunk,weights", _k1_shapes(
    [(65536, 2048, 39, 8192, "random"), (1000, 37, 13, 256, "random"),
     (777, 64, 60, 100, "random"), (2000, 3, 1, 8192, "random"),
     (10000, 2048, 39, 8192, "random"), (900, 130, 64, None, "random"),
     (300, 1, 7, None, "random")] + K1_PATH_SHAPES))
def test_k1_cuda_matches_plain(cuda_device, n, k, d, chunk, weights):
    """The default tier within its budgets of its plain version, closer
    to it than to fastStats' plain version, a rerun equal to the digit."""
    rng = np.random.default_rng(5)
    tg = _gmm(1, k, d, cuda_device)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    w = _weights(rng, n, weights)
    xt, wt = x.to(cuda_device), torch.from_numpy(w).to(cuda_device)
    before = ck.launch_counts["em_stats_fused"]
    got = ck.em_stats_fused(xt, wt, tg, chunk=chunk)
    torch.cuda.synchronize()
    assert isinstance(got, EmStats)
    assert ck.launch_counts["em_stats_fused"] == before + 1
    want = ck.em_stats_reference(xt, wt, tg)
    _check_k1(got, want, {}, weights, xt, wt, tg,
              dict(stats_pass="bf16nx"))
    # fixed-order reduction, no atomics: a rerun reproduces every digit
    again = ck.em_stats_fused(xt, wt, tg, chunk=chunk)
    for a, b in zip((again.n, again.sum_x, again.sum_xx, again.llk),
                    (got.n, got.sum_x, got.sum_xx, got.llk)):
        assert torch.equal(a, b)


# K2 at K=2048 beyond the tests' own shapes: 64 utterances of 2000 frames,
# 16 of 61, and the library slice's 500 x 2000
K2_PATH_SHAPES = [(64, 2000, 2048, 39), (16, 61, 2048, 39),
                  (500, 2000, 2048, 39)]


@pytest.mark.parametrize("s,t,k,d", [(8, 2000, 2048, 39), (5, 2060, 64, 39),
                                     (7, 61, 100, 13), (8, 2060, 2048, 39)]
                         + K2_PATH_SHAPES)
def test_k2_cuda_matches_plain(cuda_device, s, t, k, d):
    """The default tier within its budgets of its plain version, closer
    to it than to fastStats' plain version, a rerun equal to the digit."""
    rng = np.random.default_rng(6)
    tg = _gmm(2, k, d, cuda_device)
    x = rng.standard_normal((s, t, d), dtype=np.float32)
    mask = (rng.random((s, t)) < 0.7).astype(np.float32)
    mask[-1] = 0.0                       # an all-zero-weight utterance
    xt = torch.from_numpy(x).to(cuda_device)
    mt = torch.from_numpy(mask).to(cuda_device)
    before = ck.launch_counts["bw_stats_fused"]
    n, f, llk = ck.bw_stats_fused(xt, mt, tg)
    torch.cuda.synchronize()
    assert ck.launch_counts["bw_stats_fused"] == before + 1
    rn, rf, rl = ck.bw_stats_reference(xt, mt, tg)
    _close(n, rn, 1e-4)
    _close(f, rf, 1e-3)
    np.testing.assert_allclose(np_of(llk), np_of(rl), rtol=1e-5)
    assert torch.all(n[-1] == 0) and torch.all(f[-1] == 0)
    assert float(llk[-1]) == 0.0
    _closer_to_tier(f, rf,
                    ck.bw_stats_reference(xt, mt, tg, stats_pass="bf16nx")[1])
    n2, f2, l2 = ck.bw_stats_fused(xt, mt, tg)
    assert torch.equal(n2, n) and torch.equal(f2, f) and torch.equal(l2, llk)


TIERS = [(None, "bf16nx", "fastStats"), (torch.bfloat16, "x3", "fastMath"),
         (torch.bfloat16, "bf16nx", "fastMath+fastStats")]
# every arithmetic but the four tiers, as (wrapper keywords, key name)
MODES = [(m.kwargs(), m.name) for m in ck.all_modes()[4:]]
CASES = [(dict(compute_dtype=cdt, stats_pass=sp), name)
         for cdt, sp, name in TIERS] + MODES


def _tier_sum_rtol(kw):
    """S/F budget of an arithmetic: three- and six-pass stats products
    are f32-grade (1e-3); a product that rounds p or xa·s to bf16 once,
    or twice in its two-pass forms, or stochastically, gets 2e-3."""
    return 1e-3 if ck.check_mode(**kw).stats in ("3", "6") else 2e-3


def _tier_n_rtol(kw):
    """Occupancy budget: exact sums (1e-4) where n is the exact Σ p·s or
    a column of a three- or six-pass product, else that product's 2e-3."""
    mode = ck.check_mode(**kw)
    return 1e-4 if mode.nx or mode.stats in ("3", "6") else 2e-3


def _rounds(kw):
    """Whether an arithmetic rounds to bf16 where the default tier does
    not (so its kernel must sit closer to its own plain version than to
    the default's); "exp", "fast2" and "highest" with f32-grade products
    sit within f32-level differences of the default."""
    mode = ck.check_mode(**kw)
    return mode.logit_passes == 1 or mode.stats not in ("3", "6")


def _closer_to_tier(got, tier_plain, default_plain):
    """Mean |error| (a rare bf16 rounding flip moves one element by a whole
    ulp, so the max would not separate the tiers at small T)."""
    got, a, b = np_of(got), np_of(tier_plain), np_of(default_plain)
    assert np.mean(np.abs(got - a)) < 0.5 * np.mean(np.abs(got - b))


def _key(kernel, name):
    return f"{kernel}[{name}]" if name else kernel


@pytest.mark.parametrize("kw,name", CASES, ids=[c[1] for c in CASES])
@pytest.mark.parametrize("n,k,d,chunk,weights", _k1_shapes(
    [(65536, 2048, 39, 8192, "random"), (777, 64, 60, 100, "random"),
     (2000, 3, 1, None, "random"), (10000, 2048, 39, None, "random")]
    + K1_PATH_SHAPES))
def test_k1_tiers_cuda_match_plain(cuda_device, n, k, d, chunk, weights, kw,
                                   name):
    rng = np.random.default_rng(7)
    tg = _gmm(1, k, d, cuda_device)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    w = _weights(rng, n, weights)
    xt, wt = x.to(cuda_device), torch.from_numpy(w).to(cuda_device)
    key = _key("em_stats_fused", name)
    before = ck.launch_counts[key]
    got = ck.em_stats_fused(xt, wt, tg, chunk=chunk, **kw)
    torch.cuda.synchronize()
    assert ck.launch_counts[key] == before + 1
    want = ck.em_stats_reference(xt, wt, tg, **kw)
    _check_k1(got, want, kw, weights, xt, wt, tg,
              {} if _rounds(kw) else None)
    again = ck.em_stats_fused(xt, wt, tg, chunk=chunk, **kw)
    for a, b in zip((again.n, again.sum_x, again.sum_xx, again.llk),
                    (got.n, got.sum_x, got.sum_xx, got.llk)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw,name", CASES, ids=[c[1] for c in CASES])
@pytest.mark.parametrize("s,t,k,d", [(8, 2000, 2048, 39), (7, 61, 100, 13),
                                     (5, 2060, 2048, 39)] + K2_PATH_SHAPES)
def test_k2_tiers_cuda_match_plain(cuda_device, s, t, k, d, kw, name):
    rng = np.random.default_rng(8)
    tg = _gmm(2, k, d, cuda_device)
    x = rng.standard_normal((s, t, d), dtype=np.float32)
    mask = (rng.random((s, t)) < 0.7).astype(np.float32)
    mask[-1] = 0.0                       # an all-zero-weight utterance
    xt = torch.from_numpy(x).to(cuda_device)
    mt = torch.from_numpy(mask).to(cuda_device)
    key = _key("bw_stats_fused", name)
    before = ck.launch_counts[key]
    n, f, llk = ck.bw_stats_fused(xt, mt, tg, **kw)
    torch.cuda.synchronize()
    assert ck.launch_counts[key] == before + 1
    rn, rf, rl = ck.bw_stats_reference(xt, mt, tg, **kw)
    _close(n, rn, _tier_n_rtol(kw))
    _close(f, rf, _tier_sum_rtol(kw))
    np.testing.assert_allclose(np_of(llk), np_of(rl), rtol=1e-5)
    assert torch.all(n[-1] == 0) and torch.all(f[-1] == 0)
    assert float(llk[-1]) == 0.0
    if _rounds(kw):
        _closer_to_tier(f, rf, ck.bw_stats_reference(xt, mt, tg)[1])
    n2, f2, l2 = ck.bw_stats_fused(xt, mt, tg, **kw)
    assert torch.equal(n2, n) and torch.equal(f2, f) and torch.equal(l2, llk)


def test_sr_cuda_bits_follow_frames(cuda_device):
    """``"bf16sr"`` on the card keys its bits on the global frame: K1 at
    chunks of 128 and 1024 frames gives the same stats up to f32
    reordering (1e-5 of scale), K2's stats summed over utterances those
    of K1 on the flat frames, the same seed every digit again and
    another seed other digits (K1 and K2); and the kernel equals the
    plain version, which draws the same bits, within the one-pass
    budgets."""
    rng = np.random.default_rng(16)
    tg = _gmm(4, 256, 39, cuda_device)
    xt = torch.from_numpy(rng.standard_normal((4, 1500, 39),
                                              dtype=np.float32)
                          ).to(cuda_device)
    mt = torch.ones((4, 1500), device=cuda_device)
    kw = dict(stats_pass="bf16sr", seed=77)
    xf, wf = xt.reshape(-1, 39), mt.reshape(-1)
    a = ck.em_stats_fused(xf, wf, tg, chunk=128, **kw)
    b = ck.em_stats_fused(xf, wf, tg, chunk=1024, **kw)
    for f in ("n", "sum_x", "sum_xx"):
        _close(getattr(a, f), getattr(b, f), 1e-5)
    n2, f2, _ = ck.bw_stats_fused(xt, mt, tg, **kw)
    _close(n2.sum(0), a.n, 1e-5)
    _close(f2.sum(0), a.sum_x, 1e-5)
    again = ck.em_stats_fused(xf, wf, tg, chunk=128, **kw)
    assert torch.equal(again.sum_x, a.sum_x) and torch.equal(again.n, a.n)
    other = ck.em_stats_fused(xf, wf, tg, chunk=128, stats_pass="bf16sr",
                              seed=78)
    assert not torch.equal(other.sum_x, a.sum_x)
    assert not torch.equal(ck.bw_stats_fused(xt, mt, tg, stats_pass="bf16sr",
                                             seed=78)[1], f2)
    want = ck.em_stats_reference(xf, wf, tg, **kw)
    _close(a.n, want.n, 2e-3)
    _close(a.sum_x, want.sum_x, 2e-3)


def _one_hot_frames(rng, n, k, d, device):
    """Frames whose posteriors are exactly one-hot: unit variances, the mean
    of component c 20 times the bits of c over the first log2(k)
    dimensions, frame f within 0.5 of the mean of component f mod k, and
    one frame a component (drawn from the whole range) weighted in
    [0.5, 1.5), the others 0.  Every stats sum then has one nonzero term."""
    bits = int(np.log2(k))
    means = np.zeros((k, d), np.float32)
    means[:, :bits] = 20.0 * ((np.arange(k)[:, None] >> np.arange(bits)) & 1)
    f = np.arange(n)
    x = (means[f % k] + rng.uniform(-0.5, 0.5, (n, d))).astype(np.float32)
    w = np.zeros(n, np.float32)
    w[np.arange(k) + k * rng.integers(0, n // k, k)] = rng.uniform(0.5, 1.5, k)
    return (torch.from_numpy(x).to(device), torch.from_numpy(w).to(device),
            gmm_from_numpy(np.full(k, 1.0 / k), means, np.ones((k, d)),
                           device))


@pytest.mark.parametrize("stats_pass", ["bf16", "bf16sr"])
def test_sr_cuda_sums_equal_plain_on_one_hot_frames(cuda_device, stats_pass):
    """Where every sum is exact (one-hot posteriors: p is 1 or 0, so each
    statistic is the one bf16(xa·w) of its frame), K1 and K2 (T even and
    odd) equal the plain version to the digit: the kernel rounds xa·s with
    the plain version's bits, on the global frame index; and those of
    ``"bf16sr"`` are not all the round-to-nearest ones of ``"bf16"``."""
    rng = np.random.default_rng(17)
    x, w, tg = _one_hot_frames(rng, 30_000, 128, 13, cuda_device)
    kw = dict(stats_pass=stats_pass, seed=9)
    got, want = (ck.em_stats_fused(x, w, tg, **kw),
                 ck.em_stats_reference(x, w, tg, **kw))
    for f in ("n", "sum_x", "sum_xx"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if stats_pass == "bf16sr":
        nearest = ck.em_stats_fused(x, w, tg, stats_pass="bf16", seed=9)
        assert not torch.equal(got.sum_x, nearest.sum_x)
    for t in (2000, 1999):
        s = x.shape[0] // t
        xu, wu = x[:s * t].view(s, t, 13), w[:s * t].view(s, t)
        for a, b in zip(ck.bw_stats_fused(xu, wu, tg, **kw)[:2],
                        ck.bw_stats_reference(xu, wu, tg, **kw)[:2]):
            assert torch.equal(a, b), t


@pytest.mark.parametrize("t", [None, 2000, 1999])
def test_sr_cuda_draws_the_plain_versions_bits(cuda_device, t):
    """On random frames (K1, or K2 at an even and an odd T, where a thread's
    frame pair spans two counters) the kernel at one seed lies far closer
    to the plain version at that seed than the plain version at another
    seed does: rms(kernel − plain) / rms(plain seed 9 − plain seed 10)
    below 0.5 for every statistic (a kernel that drew other bits would
    sit at ~1; matched bits leave only the accumulation's differences)."""
    rng = np.random.default_rng(18)
    tg = _gmm(5, 256, 39, cuda_device)
    x = torch.from_numpy(rng.standard_normal((20_000, 39), dtype=np.float32)
                         ).to(cuda_device)
    w = torch.ones(20_000, device=cuda_device)
    if t is None:
        def run(fn, seed):
            st = fn(x, w, tg, stats_pass="bf16sr", seed=seed)
            return st.n, st.sum_x, st.sum_xx
    else:
        s = x.shape[0] // t
        xu, wu = x[:s * t].view(s, t, 39), w[:s * t].view(s, t)

        def run(fn, seed):
            return fn(xu, wu, tg, stats_pass="bf16sr", seed=seed)[:2]

    def rms(a, b):
        return float(torch.sqrt(torch.mean((a.double() - b.double()) ** 2)))

    k9 = run(ck.em_stats_fused if t is None else ck.bw_stats_fused, 9)
    p9 = run(ck.em_stats_reference if t is None else ck.bw_stats_reference, 9)
    p10 = run(ck.em_stats_reference if t is None else ck.bw_stats_reference,
              10)
    for a, b, c in zip(k9, p9, p10):
        assert rms(a, b) < 0.5 * rms(b, c)


def _f64_stats(x, w, gmm):
    """(n, sum_x, sum_xx, Σ w·llk) of x (N,D) in float64 on the card."""
    x, w = x.double(), w.double()
    mu, iv = gmm.means.double(), gmm.cov_inv.double()
    d = x.shape[1]
    ld = (torch.log(gmm.weights.double())
          - 0.5 * (d * np.log(2 * np.pi) - torch.log(iv).sum(-1))
          - 0.5 * ((x * x) @ iv.T - 2 * x @ (mu * iv).T
                   + (mu * mu * iv).sum(-1)))
    llk = torch.logsumexp(ld, dim=-1)
    g = torch.exp(ld - llk[:, None]) * w[:, None]
    return g.sum(0), g.T @ x, g.T @ (x * x), (llk * w).sum()


@pytest.mark.parametrize("n,k,d", [(65536, 2048, 39), (10000, 2048, 39),
                                   (2000, 3, 1)])
def test_default_tier_cuda_matches_float64(cuda_device, n, k, d):
    rng = np.random.default_rng(12)
    tg = _gmm(1, k, d, cuda_device)
    xt = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)
                          ).to(cuda_device)
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0.0
    wt = torch.from_numpy(w).to(cuda_device)
    got = ck.em_stats_fused(xt, wt, tg)
    n64, sx64, sxx64, llk64 = _f64_stats(xt, wt, tg)
    _close(got.n, n64, 1e-3)
    _close(got.sum_x, sx64, 1e-3)
    _close(got.sum_xx, sxx64, 1e-3)
    np.testing.assert_allclose(float(got.llk), float(llk64), rtol=1e-5)
    # K2 on the same frames as one utterance: the same function
    n2, f2, l2 = ck.bw_stats_fused(xt[None], wt[None], tg)
    _close(n2[0], n64, 1e-3)
    _close(f2[0], sx64, 1e-3)
    np.testing.assert_allclose(float(l2[0]), float(llk64), rtol=1e-5)


def test_sr_cuda_bias_follows_the_plain_versions(cuda_device):
    """On the sweeps' problem (scripts/torch_sweep_fused.make_problem's
    draws: K=2048, D=39; its first 65,536 frames) the mean signed
    occupancy error over K against float64, averaged over 64 seeds of
    ``"bf16sr"``: the plain version's lies within 4 standard errors of 0
    and below the deterministic bf16 pass's in magnitude; the kernel's
    less its bf16 pass's lies within 4 standard errors of the same
    difference of the plain versions (the tensor cores' f32 accumulation
    shifts both passes alike)."""
    seeds, ns = 64, 65536
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1_000_000, 39)).astype(np.float32)[:ns]
    means = rng.standard_normal((2048, 39)).astype(np.float32)
    cov_inv = (rng.random((2048, 39)) + 0.5).astype(np.float32)
    tg = gmm_from_numpy(np.full(2048, 1.0 / 2048, np.float32), means,
                        cov_inv, cuda_device)
    xt = torch.from_numpy(x).to(cuda_device)
    wt = torch.ones(ns, device=cuda_device)
    n64 = _f64_stats(xt, wt, tg)[0]

    def bias(fn, **kw):
        return float((fn(xt, wt, tg, **kw).n.double() - n64).mean())

    out = []
    for fn in (ck.em_stats_fused, ck.em_stats_reference):
        sr = np.array([bias(fn, stats_pass="bf16sr", seed=s)
                       for s in range(seeds)])
        out.append((sr.mean(), sr.std(ddof=1) / np.sqrt(seeds),
                    bias(fn, stats_pass="bf16")))
    (sr_k, sem_k, det_k), (sr_p, sem_p, det_p) = out
    assert abs(sr_p) <= 4 * sem_p
    assert abs(sr_p) < abs(det_p)
    assert abs((sr_k - det_k) - (sr_p - det_p)) <= 4 * np.hypot(sem_k, sem_p)


def test_k1_single_chunk_and_chunk_rule(cuda_device):
    """One chunk writes the result directly (no partials); the default
    chunk is ``stats_chunk_len(N, K)``; another chunking gives the same
    statistics within the budgets, and each reproduces every digit."""
    rng = np.random.default_rng(13)
    tg = _gmm(1, 200, 20, cuda_device)
    xt = torch.from_numpy(rng.standard_normal((3000, 20), dtype=np.float32)
                          ).to(cuda_device)
    wt = torch.ones(3000, device=cuda_device)
    one = ck.em_stats_fused(xt, wt, tg, chunk=4096)
    auto = ck.em_stats_fused(xt, wt, tg)
    same = ck.em_stats_fused(xt, wt, tg, chunk=ck.stats_chunk_len(3000, 200))
    want = ck.em_stats_reference(xt, wt, tg)
    for got in (one, auto):
        _close(got.n, want.n, 1e-4)
        _close(got.sum_x, want.sum_x, 1e-3)
        _close(got.sum_xx, want.sum_xx, 1e-3)
        np.testing.assert_allclose(float(got.llk), float(want.llk), rtol=1e-5)
    for a, b in zip((auto.n, auto.sum_x, auto.sum_xx, auto.llk, auto.count),
                    (same.n, same.sum_x, same.sum_xx, same.llk, same.count)):
        assert torch.equal(a, b)


def test_k2_unaligned_start_cuda_matches_plain(cuda_device):
    """An utterance batch that starts 4 bytes off a 16-byte boundary (and
    whose utterances start off it too: T·D odd) takes the 4-byte copies."""
    rng = np.random.default_rng(14)
    s, t, d, k = 6, 61, 13, 100
    tg = _gmm(2, k, d, cuda_device)
    flat = torch.from_numpy(rng.standard_normal(s * t * d + 1,
                                                dtype=np.float32)
                            ).to(cuda_device)
    xt = flat[1:].view(s, t, d)
    assert xt.is_contiguous() and xt.data_ptr() % 16 == 4
    mask = (rng.random((s, t)) < 0.7).astype(np.float32)
    mask[-1] = 0.0
    mt = torch.from_numpy(mask).to(cuda_device)
    for cdt, sp in [(None, "x3")] + [(a, b) for a, b, _ in TIERS]:
        n, f, llk = ck.bw_stats_fused(xt, mt, tg, compute_dtype=cdt,
                                      stats_pass=sp)
        rn, rf, rl = ck.bw_stats_reference(xt, mt, tg, compute_dtype=cdt,
                                           stats_pass=sp)
        kw = dict(compute_dtype=cdt, stats_pass=sp)
        _close(n, rn, _tier_n_rtol(kw))
        _close(f, rf, _tier_sum_rtol(kw))
        np.testing.assert_allclose(np_of(llk), np_of(rl), rtol=1e-5)
        assert torch.all(n[-1] == 0) and torch.all(f[-1] == 0)
    x1 = flat[1:1 + 300 * d].view(300, d)
    w1 = torch.ones(300, device=cuda_device)
    got, want = ck.em_stats_fused(x1, w1, tg), ck.em_stats_reference(x1, w1,
                                                                     tg)
    _close(got.n, want.n, 1e-4)
    _close(got.sum_x, want.sum_x, 1e-3)


def test_cuda_tensor_never_reaches_a_plain_path(cuda_device, monkeypatch):
    """On a CUDA tensor every entry point launches its kernel, in every
    tier and every other arithmetic: with the plain versions made to
    raise, the calls succeed and each adds one to its own launch count."""
    from lia_ral_tpu_torch.fa import stats as tstats
    from lia_ral_tpu_torch.gmm import em as tem

    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, name in ((ck, "em_stats_reference"), (ck, "bw_stats_reference"),
                      (ck, "_tier_block"), (tem, "em_stats_reference"),
                      (tem, "em_stats_chunked"),
                      (tstats, "bw_stats_reference")):
        monkeypatch.setattr(mod, name, boom)
    rng = np.random.default_rng(15)
    tg = _gmm(3, 70, 9, cuda_device)
    xt = torch.from_numpy(rng.standard_normal((4, 300, 9), dtype=np.float32)
                          ).to(cuda_device)
    mt = torch.ones((4, 300), device=cuda_device)
    for cdt, sp, name in [(None, "x3", "")] + TIERS:
        k1 = f"em_stats_fused[{name}]" if name else "em_stats_fused"
        k2 = f"bw_stats_fused[{name}]" if name else "bw_stats_fused"
        before = dict(ck.launch_counts)
        ck.em_stats_fused(xt.reshape(-1, 9), mt.reshape(-1), tg,
                          compute_dtype=cdt, stats_pass=sp)
        tem.default_stats_fn(fast_math=cdt is not None,
                             fast_stats=sp == "bf16nx")(
            xt.reshape(-1, 9), mt.reshape(-1), tg)
        ck.bw_stats_fused(xt, mt, tg, compute_dtype=cdt, stats_pass=sp)
        torch.cuda.synchronize()
        assert ck.launch_counts[k1] == before[k1] + 2
        assert ck.launch_counts[k2] == before[k2] + 1
    for kw, name in MODES:
        before = dict(ck.launch_counts)
        ck.em_stats_fused(xt.reshape(-1, 9), mt.reshape(-1), tg, **kw)
        ck.bw_stats_fused(xt, mt, tg, **kw)
        tstats.bw_stats_batch(xt, mt, tg, stats_pass=kw["stats_pass"])
        torch.cuda.synchronize()
        k1, k2 = _key("em_stats_fused", name), _key("bw_stats_fused", name)
        assert ck.launch_counts[k1] == before[k1] + 1
        k2_batch = _key("bw_stats_fused", ck.check_mode(
            stats_pass=kw["stats_pass"]).name)
        assert ck.launch_counts[k2] == before[k2] + 1 + (k2_batch == k2)
        assert ck.launch_counts[k2_batch] == before[k2_batch] + 1 + (
            k2_batch == k2)
    before = ck.launch_counts["bw_stats_fused"]
    tstats.bw_stats_batch(xt, mt, tg)
    assert ck.launch_counts["bw_stats_fused"] == before + 1


def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    tg = _gmm(3, 8, 5, cuda_device)
    x = torch.zeros((16, 5), device=cuda_device)
    w = torch.ones(16, device=cuda_device)
    with pytest.raises(TypeError):
        ck.em_stats_fused(x.double(), w, tg)
    with pytest.raises(ValueError):
        ck.em_stats_fused(x.t().contiguous().t(), w, tg)   # not contiguous
    with pytest.raises(ValueError):
        ck.em_stats_fused(x, w.cpu(), tg)                  # mixed devices
    with pytest.raises(ValueError):
        ck.bw_stats_fused(x, w, tg)                        # not (S,T,D)
    with pytest.raises(ValueError):
        ck.em_stats_fused(torch.zeros((16, 65), device=cuda_device), w,
                          _gmm(3, 8, 65, cuda_device))     # D above 64


def test_gmm_ubm_path_runs_k1_on_cuda(cuda_device):
    """MAP adaptation (K1 at a client's shape) and the energy VAD (K1 at
    K=3, D=1) launch K1 on CUDA tensors and agree with their CPU runs
    (the plain path); top-K scoring on the card agrees with the CPU to
    1e-4 in the LLR."""
    from lia_ral_tpu_torch.frontend.energy_vad import (EnergyDetectorCfg,
                                                        energy_detector)
    from lia_ral_tpu_torch.gmm.map_adapt import MapCfg, adapt_model
    from lia_ral_tpu_torch.gmm.scoring import compute_test_llr, stack_gmms

    rng = np.random.default_rng(11)
    world = _gmm(4, 256, 20, "cpu")
    x = torch.from_numpy(rng.standard_normal((6000, 20), dtype=np.float32))
    w = torch.ones(6000)
    cfg = MapCfg(nb_train_it=2)
    before = ck.launch_counts["em_stats_fused"]
    got = adapt_model(torch.Generator(cuda_device), x.to(cuda_device),
                      w.to(cuda_device), world.to(cuda_device), cfg)
    assert ck.launch_counts["em_stats_fused"] == before + 2
    want = adapt_model(torch.Generator(), x, w, world, cfg)
    _close(got.means, want.means, 1e-4)

    energy = np.where(rng.random(3000) < 0.3, rng.normal(-3, 0.5, 3000),
                      rng.normal(2, 1, 3000)).astype(np.float32)
    ew = np.ones(3000, np.float32)
    before = ck.launch_counts["em_stats_fused"]
    speech = energy_detector(energy, ew, EnergyDetectorCfg(),
                             device=cuda_device)
    assert ck.launch_counts["em_stats_fused"] == before + 10
    assert (speech == energy_detector(energy, ew, EnergyDetectorCfg())).all()

    clients = stack_gmms([want, world])
    llr = compute_test_llr(x[:2000].to(cuda_device), w[:2000].to(cuda_device),
                           world.to(cuda_device), clients.to(cuda_device))
    _close(llr.cpu(), compute_test_llr(x[:2000], w[:2000], world, clients),
           1e-4)


def test_jfa_session_stats_run_k2_on_cuda(cuda_device, tmp_path):
    """``accumulate_session_stats`` (ComputeJFAStats, and TrainTarget JFA
    on the target list) on a CUDA GMM launches K2 once per length bucket
    and batch, in the default tier and with fastStats, and matches its
    run on the CPU (the plain versions) within K2's budgets: n 1e-4, F
    1e-3 of scale (2e-3 with fastStats)."""
    from lia_ral_tpu_torch.config import Config
    from lia_ral_tpu_torch.io.features import write_feature_file
    from lia_ral_tpu_torch.io.lists import write_xlist
    from lia_ral_tpu_torch.tools.jfa_tools import accumulate_session_stats

    rng = np.random.default_rng(21)
    d = str(tmp_path)
    # 5 sessions in the 2048-frame bucket, 2 in the 4096-frame one
    lens = [700, 2048, 1500, 3000, 900, 2049, 100]
    names = [f"s{i}" for i in range(len(lens))]
    for name, t in zip(names, lens):
        write_feature_file(f"{d}/{name}.prm",
                           rng.standard_normal((t, 20), dtype=np.float32),
                           fmt="SPRO4")
    write_xlist(f"{d}/s.ndx", [["a"] + names[:3], ["b"] + names[3:5],
                               ["a"] + names[5:]])
    world = _gmm(6, 128, 20, "cpu")
    for fast, key, rtol in (("false", "bw_stats_fused", 1e-3),
                            ("true", "bw_stats_fused[fastStats]", 2e-3)):
        cfg = Config({"featureFilesPath": d + "/", "labelFilesPath": d + "/",
                      "loadFeatureFileFormat": "SPRO4",
                      "addDefaultLabel": "true", "defaultLabel": "speech",
                      "ndxFilename": f"{d}/s.ndx", "statsBatchSize": "4",
                      "fastStats": fast})
        before = ck.launch_counts[key]
        got, spk, sess = accumulate_session_stats(cfg, world.to(cuda_device))
        # ceil(5 / 4) batches of 2048 frames + 1 batch of 4096
        assert ck.launch_counts[key] == before + 3
        assert got.sess.n.device.type == "cuda"
        assert spk == ["a", "b"] and sess == names
        assert got.sess_spk.tolist() == [0, 0, 0, 1, 1, 0, 0]
        want, _, _ = accumulate_session_stats(cfg, world)
        assert ck.launch_counts[key] == before + 3      # CPU: plain version
        for g, w_ in ((got.sess, want.sess), (got.spk, want.spk)):
            _close(g.n, w_.n, 1e-4)
            _close(g.f, w_.f, rtol)
        # every frame has weight 1: the occupancies sum to the lengths
        np.testing.assert_allclose(np_of(got.sess.n).sum(1), lens, rtol=1e-4)


# -- the Viterbi decoder --------------------------------------------------------

@pytest.mark.parametrize("n,s", [(30000, 5), (1, 1), (1, 7), (2, 3),
                                 (1025, 2), (1026, 32), (4097, 9),
                                 (33, 16), (65, 4)])
def test_viterbi_cuda_equals_plain_loop(cuda_device, n, s):
    """The kernel's path equals ``viterbi_reference``'s state for state
    (f32 adds and maxima only), at the diarization's length and around
    the ring's 64-step chunks and the backtrace's 256 chunks, and it
    counts one launch; a rerun gives the same path."""
    from lia_ral_tpu_torch.seg import hmm

    rng = np.random.default_rng(31)
    em = torch.from_numpy((rng.standard_normal((n, s)) * 3)
                          .astype(np.float32)).to(cuda_device)
    lt = torch.log(torch.from_numpy(hmm.compute_transitions(s)
                                    .astype(np.float32)) + 1e-30
                   ).to(cuda_device)
    before = hmm.launch_counts["viterbi"]
    got = hmm.viterbi_cuda(em, lt)
    torch.cuda.synchronize()
    assert hmm.launch_counts["viterbi"] == before + 1
    assert got.dtype == torch.int64 and got.shape == (n,)
    want = hmm.viterbi_reference(em.cpu(), lt.cpu())
    assert torch.equal(got.cpu(), want)
    assert torch.equal(hmm._viterbi(em, lt), got)


def _viterbi_case(n, s, seed):
    rng = np.random.default_rng(seed)
    em = torch.from_numpy((rng.standard_normal((n, s)) * 3)
                          .astype(np.float32))
    lt = torch.log(torch.from_numpy(compute_transitions(s)
                                    .astype(np.float32)) + 1e-30)
    return em, lt


@pytest.mark.parametrize("s", [1, 2, 3, 5, 8, 9, 12, 16, 17, 20, 24, 28,
                               32])
@pytest.mark.parametrize("n", [2, 63, 64, 65, 66, 129, 130, 256, 257,
                               258, 513])
def test_viterbi_cuda_every_state_count_at_the_chunk_edges(cuda_device, n,
                                                           s):
    """Every instance of the kernel (S exact up to 8, rounded up to a
    multiple of 4 above) at the edges of the ring's 64-step chunks, which
    the forward publishes, and of the consumers' 64-row units (N - 1
    rows: one unit at N = 65, two at 66)."""
    from lia_ral_tpu_torch.seg import hmm

    em, lt = _viterbi_case(n, s, 40 + s)
    got = hmm.viterbi_cuda(em.to(cuda_device), lt.to(cuda_device))
    assert torch.equal(got.cpu(), hmm.viterbi_reference(em, lt))


@pytest.mark.parametrize("s", [5, 32])
def test_viterbi_cuda_back_pointers_past_shared_memory(cuda_device, s):
    """The library's shared memory a block is the plan's, for every S;
    where the layout before spilled back pointers from shared into device
    memory (its 198,400 bytes full, one row and two rows over) and (S = 5)
    at N = 60,000, the path equals the plain loop's; so it does at 256
    and 257 units, where each tail thread composes one unit map, then
    two."""
    from lia_ral_tpu_torch.seg import hmm

    lib = _build.library("viterbi")
    for states in range(1, 33):
        assert lib.lia_viterbi_shared_bytes(states) == hmm.shared_bytes(
            states)
    full = 198_400 // s + 1
    for n in ((full, full + 1, full + 2, 256 * 64 + 1, 256 * 64 + 2)
              + ((60000,) if s == 5 else ())):
        em, lt = _viterbi_case(n, s, n)
        got = hmm.viterbi_cuda(em.to(cuda_device), lt.to(cuda_device))
        assert torch.equal(got.cpu(), hmm.viterbi_reference(em, lt)), n


def test_viterbi_cuda_at_the_diarization_cell_shape(cuda_device):
    """One decode as the broadcast-news cell makes it: 300,000 frames of
    24 states, 13 active, the other 11 at −1e30 with log 1e-30
    transitions: the path equals the plain loop's and stays in the active
    states."""
    from lia_ral_tpu_torch.seg import hmm

    rng = np.random.default_rng(34)
    em = (rng.standard_normal((300_000, 24)) * 3).astype(np.float32)
    em[:, 13:] = -1e30
    t = np.full((24, 24), 1e-30)
    t[:13, :13] = hmm.compute_transitions(13)
    em = torch.from_numpy(em)
    lt = torch.log(torch.from_numpy(t.astype(np.float32)))
    got = hmm.viterbi_cuda(em.to(cuda_device), lt.to(cuda_device)).cpu()
    assert int(got.max()) < 13
    assert torch.equal(got, hmm.viterbi_reference(em, lt))


@pytest.mark.parametrize("s", [1, 5, 12, 24, 32])
def test_viterbi_cuda_on_log_densities(cuda_device, s):
    """Emissions as log densities (all negative, a third of the states at
    −1e30) and log-probability transitions: the path equals the plain
    loop's."""
    from lia_ral_tpu_torch.seg import hmm

    rng = np.random.default_rng(36 + s)
    n, active = 5000, max(1, s - s // 3)
    em = -np.abs(rng.standard_normal((n, s)) * 3).astype(np.float32) - 20
    em[:, active:] = -1e30
    t = np.full((s, s), 1e-30)
    t[:active, :active] = hmm.compute_transitions(active)
    em = torch.from_numpy(em)
    lt = torch.log(torch.from_numpy(t.astype(np.float32)))
    got = hmm.viterbi_cuda(em.to(cuda_device), lt.to(cuda_device))
    assert torch.equal(got.cpu(), hmm.viterbi_reference(em, lt))


def test_viterbi_cuda_counts_its_tail_under_a_profiler(cuda_device):
    """Under a profiler a decode counts its N − 1 back pointer rows and
    fewer rows not yet derived when its forward ended (the consumers keep
    up with the forward); with no profiler it counts nothing."""
    from torch.autograd import profiler

    from lia_ral_tpu_torch.seg import hmm
    from lia_ral_tpu_torch.utils import logging as tlog

    em, lt = _viterbi_case(100_000, 24, 35)
    em, lt = em.to(cuda_device), lt.to(cuda_device)
    names = ("lia.seg.viterbi_bp_rows", "lia.seg.viterbi_tail_rows")
    before = [tlog.counters[k] for k in names]
    hmm.viterbi_cuda(em, lt)
    assert [tlog.counters[k] for k in names] == before
    with profiler.profile():
        hmm.viterbi_cuda(em, lt)
    bp, tail = (tlog.counters[k] - b for k, b in zip(names, before))
    assert bp == 99_999
    assert 0 <= tail < bp


def test_viterbi_cuda_ties_and_inactive_states(cuda_device):
    """Ties (emissions on a coarse grid, uniform transitions) go to the
    first index as in the plain loop; inactive states (emission −1e30,
    transition log 1e-30) are never entered."""
    from lia_ral_tpu_torch.seg import hmm

    rng = np.random.default_rng(32)
    em = torch.from_numpy(rng.integers(0, 2, (5000, 4)).astype(np.float32))
    lt = torch.zeros((4, 4))
    got = hmm.viterbi_cuda(em.to(cuda_device), lt.to(cuda_device))
    assert torch.equal(got.cpu(), hmm.viterbi_reference(em, lt))
    em = torch.from_numpy((rng.standard_normal((5000, 5)) * 2)
                          .astype(np.float32))
    em[:, 3:] = -1e30
    t = np.full((5, 5), 1e-30)
    t[:3, :3] = hmm.compute_transitions(3)
    lt = torch.log(torch.from_numpy(t.astype(np.float32)))
    got = hmm.viterbi_cuda(em.to(cuda_device), lt.to(cuda_device))
    assert int(got.max()) < 3
    assert torch.equal(got.cpu(), hmm.viterbi_reference(em, lt))


def test_viterbi_cuda_never_reaches_the_plain_loop(cuda_device, monkeypatch):
    """A CUDA tensor launches the kernel through every entry point of the
    diarization stack, with the plain loop made to raise; bad inputs
    raise."""
    from lia_ral_tpu_torch.seg import diarization, hmm

    def boom(*args, **kwargs):
        raise AssertionError("the plain loop ran on a CUDA tensor")

    monkeypatch.setattr(hmm, "viterbi_reference", boom)
    rng = np.random.default_rng(33)
    x = np.concatenate([rng.standard_normal((300, 6)) + m
                        for m in (3.0, -3.0, 3.0)]).astype(np.float32)
    models = [gmm_from_numpy(np.ones(1, np.float32),
                             np.full((1, 6), m, np.float32),
                             np.ones((1, 6), np.float32), device=cuda_device)
              for m in (3.0, -3.0)]
    before = hmm.launch_counts["viterbi"]
    _, path = diarization.acoustic_segmentation(x, models, ["a", "b"])
    assert hmm.launch_counts["viterbi"] == before + 1
    assert (path[:299] == 0).all() and (path[300:599] == 1).all()
    world = _gmm(5, 8, 6, cuda_device)
    k1 = ck.launch_counts["em_stats_fused"]
    k1g = ck.launch_counts["em_stats_fused_grouped"]
    diarization.e_hmm_segmentation(x, world, max_speakers=2,
                                   init_seg_frames=100, nb_decode_it=1)
    # 1 + 1·(1 + 1) adaptations × 3 MAP iterations, one grouped K1 launch
    # each over both rows; 2 + 1·2 decodes
    assert ck.launch_counts["em_stats_fused_grouped"] == k1g + 3 * 3
    assert ck.launch_counts["em_stats_fused"] == k1
    assert hmm.launch_counts["viterbi"] == before + 1 + 4
    em = torch.zeros((10, 3), device=cuda_device)
    with pytest.raises(ValueError):
        hmm.viterbi_cuda(torch.zeros((10, 33), device=cuda_device),
                         torch.zeros((33, 33), device=cuda_device))
    with pytest.raises(TypeError):
        hmm.viterbi_cuda(em.double(), torch.zeros((3, 3),
                                                  device=cuda_device))
    with pytest.raises(ValueError):
        hmm.viterbi_cuda(em, torch.zeros((3, 3)))


def test_state_adapt_on_cuda_keeps_empty_rows(cuda_device):
    """K1 gives a zero-weight frame s = 0, so a state row whose mask is
    all zero comes back as the world, every number finite, on the card
    too."""
    from lia_ral_tpu_torch.seg import diarization

    rng = np.random.default_rng(34)
    world = _gmm(6, 128, 24, cuda_device)
    x = torch.from_numpy(rng.standard_normal((3000, 24), dtype=np.float32)
                         ).to(cuda_device)
    masks = torch.zeros((2, 3000), device=cuda_device)
    masks[0, :1500] = 1.0
    g = torch.Generator(device=cuda_device)
    bank = diarization._batched_state_adapt(g, x, masks, world, map_reg=3.0)
    for t in (bank.weights, bank.means, bank.cov_inv):
        assert torch.isfinite(t).all()
    assert torch.equal(bank.means[1], world.means)
    _close(bank.weights[1], world.weights, 1e-6)
    assert not torch.equal(bank.means[0], world.means)


# -- the SVM dual solver (csrc/svm_dual.cu) ------------------------------------

def _svm_problem(seed, n_tgt, n_coh, d, device):
    """A 1-target-vs-cohort problem (the JAX parity test's shape)."""
    rng = np.random.default_rng(seed)
    x = np.vstack([rng.standard_normal((n_tgt, d)) * 0.3 + 1.2,
                   rng.standard_normal((n_coh, d))]).astype(np.float32)
    y = np.r_[np.ones(n_tgt), -np.ones(n_coh)].astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


@pytest.mark.parametrize("n_tgt,n_coh,d,kind,penalty", [
    (5, 50, 4000, "linear", None), (5, 50, 4000, "rbf", None),
    (5, 50, 4000, "linear", 10.0), (3, 60, 40, "poly", None),
    (1, 1000, 512, "linear", None), (40, 1, 64, "linear", None)])
def test_svm_dual_cuda_matches_plain(cuda_device, n_tgt, n_coh, d, kind,
                                     penalty):
    """α within 1e-3·C of the plain loop on the same K, decisions within
    1e-3 of their scale (sums in another order, carried through 500 FISTA
    steps), and a rerun equal to the digit."""
    from lia_ral_tpu_torch.backend import svm

    x, y = _svm_problem(7, n_tgt, n_coh, d, cuda_device)
    c = svm.default_c(x.cpu().numpy())
    c_vec = torch.full_like(y, c)
    if penalty:
        c_vec[y > 0] *= penalty
    k = svm.kernel_matrix(x, x, kind, degree=2)
    before = svm.launch_counts["svm_dual"]
    got = svm.dual_solve_cuda(k, y, c_vec)
    torch.cuda.synchronize()
    assert svm.launch_counts["svm_dual"] == before + 1
    want = svm.dual_solve_reference(k, y, c_vec)
    assert float((got - want).abs().max()) <= 1e-3 * float(c_vec.max())
    _close(k @ (got * y), k @ (want * y), 1e-3)
    again = svm.dual_solve_cuda(k, y, c_vec)
    assert torch.equal(again, got)


def test_svm_dual_cuda_batch_equals_single(cuda_device):
    """B problems on the grid: each block solves its own problem, digit
    for digit as alone."""
    from lia_ral_tpu_torch.backend import svm

    ks, ys, cs = [], [], []
    for seed in range(3):
        x, y = _svm_problem(seed, 4, 30, 100, cuda_device)
        ks.append(svm.kernel_matrix(x, x))
        ys.append(y)
        cs.append(torch.full_like(y, svm.default_c(x.cpu().numpy())))
    got = svm.dual_solve_cuda(torch.stack(ks), torch.stack(ys),
                              torch.stack(cs))
    for i in range(3):
        assert torch.equal(got[i], svm.dual_solve_cuda(ks[i], ys[i], cs[i]))


def test_svm_train_runs_the_kernel_once(cuda_device, monkeypatch):
    """svm_train on a CUDA tensor launches the kernel once and never the
    plain loop; the model it gives separates its two classes."""
    from lia_ral_tpu_torch.backend import svm

    def boom(*a, **kw):
        raise AssertionError("plain dual solve reached from a CUDA tensor")

    monkeypatch.setattr(svm, "dual_solve_reference", boom)
    x, y = _svm_problem(3, 5, 50, 300, cuda_device)
    before = svm.launch_counts["svm_dual"]
    model = svm.svm_train(x, y.cpu().numpy(), target_penalty=10.0)
    assert svm.launch_counts["svm_dual"] == before + 1
    dec = model.decision(x).cpu().numpy()
    assert dec[:5].min() > dec[5:].max()


def _raw_supervectors(device):
    """Supervector-like vectors with a large common part (a shared mean,
    speaker and rank-64 channel offsets of 5 % of its norm): a target's
    side and 4,095 sides of other speakers, N = 4,096; y."""
    g = torch.Generator(device=device).manual_seed(20)
    d, rank, scale = 8192, 64, 0.05 / 2 ** 0.5
    mean = torch.randn(d, generator=g, device=device)
    spk = torch.randn(1366, d, generator=g, device=device) * scale
    chan = (torch.randn(rank, d, generator=g, device=device)
            * (scale / rank ** 0.5))
    x = (mean + spk.repeat_interleave(3, 0)
         + torch.randn(3 * 1366, rank, generator=g, device=device) @ chan)
    x = torch.cat([x[1:2], x[3:]])        # a target's side, other speakers
    return x, np.r_[1.0, -np.ones(x.shape[0] - 1)].astype(np.float32)


def test_svm_train_reaches_the_optimum_on_raw_supervectors(cuda_device):
    """svm_train on supervector-like vectors with a large common part (a
    shared mean, speaker and rank-64 channel offsets of 5 % of its norm;
    one target against 4,095 sides, N = 4,096: the streaming plan, one
    launch) gives the primal weights of the float64 SMO optimum of
    ``tests/plain_ref/gmm_svm_nap.py`` and its scores within the GMM-SVM
    cell's ``w_gap_rel`` and ``score_gap`` limits, where 500 FISTA steps
    on the raw vectors do not come near it."""
    from lia_ral_tpu_torch.backend import svm
    from plain_ref import gmm_svm_nap as ref

    limits = json.loads((Path(__file__).resolve().parent.parent
                         / "benchmark" / "workloads"
                         / "gmm_svm_nap_campbell2006.enrol_1conv.json"
                         ).read_text())["limits"]
    limit = limits["w_gap_rel"]
    x, y = _raw_supervectors(cuda_device)
    n = x.shape[0]
    assert n == 4096 and svm.solve_plan(n, svm.card_max_cluster()).regime \
        == "streaming"
    before = svm.launch_counts["svm_dual"]
    model = svm.svm_train(x, y)
    assert svm.launch_counts["svm_dual"] == before + 1
    w = (torch.as_tensor(model.alpha_y, device=cuda_device).double()
         @ torch.as_tensor(model.support, device=cuda_device).double())
    w_ref, b_ref, _, _ = ref.svm_train(x[:1].double(), x[1:].double())
    gap = float((w - w_ref[0]).norm() / w_ref[0].norm())
    assert gap <= limit, gap
    # the same 500 steps on the untranslated vectors
    k = svm.kernel_matrix(x, x)
    a_raw = svm.dual_solve_cuda(k, torch.as_tensor(y, device=cuda_device),
                                torch.full((n,), svm.default_c(
                                    x.cpu().numpy()), device=cuda_device))
    w_raw = (a_raw.double() * torch.as_tensor(y, device=cuda_device)
             .double()) @ x.double()
    assert float((w_raw - w_ref[0]).norm() / w_ref[0].norm()) > 10 * limit
    scores = model.decision(x[:64]).double()
    want = x[:64].double() @ w_ref[0] + b_ref[0]
    gap = float((scores - want).abs().max() / want.std())
    assert gap <= limits["score_gap"], gap


def test_svm_train_keeps_its_model_on_the_card(cuda_device, monkeypatch,
                                               tmp_path):
    """svm_train at N = 4,096 (the streaming plan): the model's support
    rows and α·y stay CUDA tensors; under a profiler the solve reads 16
    bytes back (the support count and the bias, its one host sync), hands
    the card y alone, and makes one synchronising call; its support set,
    α·y and bias are the host formulas' (``tests/_svm_host_model.py``) on
    host copies of that solve's α and K; ``SvmModel.host`` reads it into
    numpy arrays, whose decisions equal the card model's."""
    import warnings

    from lia_ral_tpu_torch.backend import svm
    from lia_ral_tpu_torch.utils import logging as tlog

    from _svm_host_model import default_c64, host_model

    x, y = _raw_supervectors(cuda_device)
    n = x.shape[0]
    svm.svm_train(x, y)                              # warm
    seen = []
    inner = svm._dual_solve

    def recorded(k, yt, c_vec, n_iter=500):
        alpha = inner(k, yt, c_vec, n_iter)
        seen.append((k, yt, c_vec, alpha))
        return alpha
    monkeypatch.setattr(svm, "_dual_solve", recorded)
    with tlog.profile_trace(str(tmp_path / "tr")):
        model = svm.svm_train(x, y)
    counted = json.loads((tmp_path / "tr" / "counters.json").read_text())
    assert counted["lia.svm.host_syncs"] == 1
    assert counted["lia.svm.d2h_bytes"] == 16
    assert counted["lia.svm.h2d_bytes"] == 4 * n
    for t in (model.support, model.alpha_y):
        assert isinstance(t, torch.Tensor) and t.device == x.device
    assert isinstance(model.bias, float)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            svm.svm_train(x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]

    k, yt, c_vec, alpha = (t.cpu().numpy() for t in seen[0])
    x_np = x.cpu().numpy()
    c = default_c64(x_np)
    np.testing.assert_array_equal(yt, y)
    np.testing.assert_allclose(c_vec, np.float32(c), rtol=1.2e-7, atol=0)
    support, alpha_y, bias, margin = host_model(
        x_np, y, alpha, k, c_vec, c, x.mean(dim=0).cpu().numpy())
    assert 0 < margin < len(support) < n
    np.testing.assert_array_equal(model.support.cpu().numpy(), support)
    np.testing.assert_allclose(model.alpha_y.cpu().numpy(), alpha_y,
                               rtol=1e-12, atol=0)
    scale = float(np.abs(alpha_y).sum()) * (
        np.abs(k).max() + np.abs(x_np).max() * np.abs(x_np).sum(1).max())
    assert abs(model.bias - bias) <= 1e-13 * scale, (model.bias, bias)

    host = model.host()
    for key in ("support", "alpha_y"):
        assert type(getattr(host, key)) is np.ndarray
        np.testing.assert_array_equal(getattr(host, key),
                                      getattr(model, key).cpu().numpy())
    assert torch.equal(model.decision(x[:64]), host.decision(x[:64]))


def test_svm_dual_cuda_rejects_bad_inputs(cuda_device):
    from lia_ral_tpu_torch.backend import svm

    n = svm.MAX_VECTORS + 1
    y = torch.ones(n, device=cuda_device)
    with pytest.raises(ValueError, match="8192"):
        svm.dual_solve_cuda(torch.zeros((n, n), device=cuda_device), y, y)
    y = torch.ones(4, device=cuda_device)
    with pytest.raises(TypeError):
        svm.dual_solve_cuda(torch.zeros((4, 4), device=cuda_device,
                                        dtype=torch.float64), y, y)
    with pytest.raises(ValueError):
        svm.dual_solve_cuda(torch.zeros((4, 4)), y.cpu(), y.cpu())
    with pytest.raises(ValueError):
        svm.dual_solve_cuda(torch.zeros((4, 5), device=cuda_device), y, y)


def _latent_problem(n, kind, seed, device, d=512):
    """One target against an N - 1 cohort (N // 10 targets from N = 20)
    of vectors with a 16-dimensional latent structure under noise (as
    chip_smoke's N = 1,001 problem); rbf takes γ = 1/median d²."""
    from lia_ral_tpu_torch.backend import svm

    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((16, d)).astype(np.float32) / 4.0
    x = (rng.standard_normal((n, 16)).astype(np.float32) @ basis
         + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    n_tgt = max(1, n // 10) if n >= 20 else 1
    x[:n_tgt] += basis[0]
    y = np.r_[np.ones(n_tgt), -np.ones(n - n_tgt)].astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    gamma = 0.0
    if kind == "rbf":
        sq = (xt * xt).sum(1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * xt @ xt.T
        gamma = 1.0 / float(d2[d2 > 0].median()) if n > 1 else 1.0
    k = svm.kernel_matrix(xt, xt, kind, gamma=gamma).contiguous()
    c = torch.full((n,), svm.default_c(x), device=device)
    return k, torch.from_numpy(y).to(device), c


def _dual_objective(k, y, a):
    k, y, a = (t.detach().cpu().double() for t in (k, y, a))
    return float(a.sum() - 0.5 * a @ (k * (y[:, None] * y[None, :])) @ a)


# the last N whose slices of Q a 16-block cluster holds in shared memory
# (tests/test_torch_svm_tree.py pins it); the next streams
LAST_RESIDENT_N = 928
REGIME_N = [1, 31, 32, 33, 55, 64, 65, RESIDENT_LIMIT, RESIDENT_LIMIT + 1,
            600, LAST_RESIDENT_N, LAST_RESIDENT_N + 1, 1001, 4096]


@pytest.mark.parametrize("n,kind", [(n, kind) for n in REGIME_N
                                    for kind in ("linear", "rbf")]
                         + [(8192, "linear")])
def test_svm_dual_cuda_every_regime_matches_plain(cuda_device, n, kind):
    """Each regime of the kernel (one warp, one block, a cluster of 2 to
    16 blocks holding Q, a 16-block cluster streaming it, up to
    MAX_VECTORS) against the plain loop on the CPU: α within 1e-3·C, or
    within twice the distance the plain loop moves when only its element
    order is reversed; the dual objective within 1e-4; one launch; a
    rerun equal to the digit."""
    from lia_ral_tpu_torch.backend import svm

    k, y, c = _latent_problem(n, kind, n, cuda_device)
    plan = svm.solve_plan(n, svm.card_max_cluster())
    assert plan.regime == ("one-warp" if n <= 64 else "one-block"
                           if n <= RESIDENT_LIMIT else "cluster"
                           if n <= LAST_RESIDENT_N else "streaming")
    before = svm.launch_counts["svm_dual"]
    got = svm.dual_solve_cuda(k, y, c)
    torch.cuda.synchronize()
    assert svm.launch_counts["svm_dual"] == before + 1
    want = svm.dual_solve_reference(k.cpu(), y.cpu(), c.cpu())
    da = float((got.cpu() - want).abs().max())
    tol = 1e-3 * float(c.max())
    if da > tol:
        rev = svm.dual_solve_reference(k.cpu().flip(0).flip(1),
                                       y.cpu().flip(0),
                                       c.cpu().flip(0)).flip(0)
        tol = max(tol, 2 * float((rev - want).abs().max()))
    assert da <= tol
    og, ow = _dual_objective(k, y, got), _dual_objective(k, y, want)
    assert abs(og - ow) <= 1e-4 * abs(ow)
    assert torch.equal(svm.dual_solve_cuda(k, y, c), got)


@pytest.mark.parametrize("n", [55, RESIDENT_LIMIT + 1, 1001])
def test_svm_dual_cuda_labels_other_than_unit(cuda_device, n):
    """Labels of magnitude 2 and 0.5 (the JAX op takes any y) keep the
    plain loop's separate products in the bisection: α within 1e-3·C of
    the plain loop, or within twice its reversed-order spread."""
    from lia_ral_tpu_torch.backend import svm

    k, y, c = _latent_problem(n, "linear", n + 1, cuda_device)
    y = y * torch.where(torch.arange(n, device=cuda_device) % 3 == 0,
                        2.0, 0.5)
    got = svm.dual_solve_cuda(k, y, c)
    want = svm.dual_solve_reference(k.cpu(), y.cpu(), c.cpu())
    da = float((got.cpu() - want).abs().max())
    tol = 1e-3 * float(c.max())
    if da > tol:
        rev = svm.dual_solve_reference(k.cpu().flip(0).flip(1),
                                       y.cpu().flip(0),
                                       c.cpu().flip(0)).flip(0)
        tol = max(tol, 2 * float((rev - want).abs().max()))
    assert da <= tol
    assert torch.equal(svm.dual_solve_cuda(k, y, c), got)


@pytest.mark.parametrize("n", [RESIDENT_LIMIT + 1, 1001])
def test_svm_dual_cuda_batch_equals_single_in_a_cluster(cuda_device, n):
    """B problems on the grid of clusters: each cluster solves its own
    problem, digit for digit as alone."""
    from lia_ral_tpu_torch.backend import svm

    probs = [_latent_problem(n, "linear", seed, cuda_device)
             for seed in (1, 2)]
    got = svm.dual_solve_cuda(*(torch.stack(t) for t in zip(*probs)))
    for i, (k, y, c) in enumerate(probs):
        assert torch.equal(got[i], svm.dual_solve_cuda(k, y, c))


def test_svm_dual_plan_layout_is_the_kernels(cuda_device):
    """solve_plan's shared-memory figures, which it computes without a
    card, are the kernel library's own for every N it accepts."""
    from lia_ral_tpu_torch.backend import svm

    lib = _build.library("svm_dual")
    assert lib.lia_svm_shared_limit() == svm.SMEM_BYTES
    for n in range(1, svm.MAX_VECTORS + 1):
        p = svm.solve_plan(n, svm.card_max_cluster())
        assert lib.lia_svm_shared_bytes(n, p.rows, p.tile,
                                        int(p.resident)) == p.smem, p


def test_svm_dual_cuda_card_runs_the_largest_cluster(cuda_device):
    """The card co-schedules the 16-block cluster that the streaming
    regime needs at MAX_VECTORS."""
    from lia_ral_tpu_torch.backend import svm

    assert svm.card_max_cluster() == svm.MAX_CLUSTER
    assert svm.solve_plan(svm.MAX_VECTORS, svm.card_max_cluster()).threads \
        <= svm.MAX_THREADS


def _tv_statistics(device, sessions=4096, k=2048, d=60, r=400,
                   frames=15000):
    """A UBM and (N, F) of ``sessions`` sessions of ``frames`` frames at
    the TV cell's widths, drawn directly: occupancies spread around the
    UBM's weights, first-order sums around each session's means moved by
    its supervector shift T_genᵀw (0.5 of the UBM's σ)."""
    from lia_ral_tpu_torch.fa.stats import BwStats
    from lia_ral_tpu_torch.gmm.model import GmmDiag

    g = torch.Generator(device=device).manual_seed(22)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)
    ww = rand(k) + 0.5
    ww = ww / ww.sum()
    wm, wv = randn(k, d) * 0.37, rand(k, d) + 0.5
    t_gen = randn(r, k, d) * (0.5 / r ** 0.5) * wv.sqrt()
    occ = ww * (0.5 + rand(sessions, k))
    n = frames * occ / occ.sum(1, keepdim=True)
    shift = (randn(sessions, r) @ t_gen.reshape(r, -1)).reshape(-1, k, d)
    f = (n[..., None] * (wm + shift)
         + n.sqrt()[..., None] * wv.sqrt() * randn(sessions, k, d))
    return (GmmDiag(weights=ww, means=wm, cov_inv=1.0 / wv), wv,
            BwStats(n=n, f=f))


def _tv_limits():
    return json.loads((Path(__file__).resolve().parent.parent
                       / "benchmark" / "workloads"
                       / "ivec_dehak2011.tv_train.json").read_text())["limits"]


def _tv_gaps(t, means, w, want, weights, var):
    """The TV cell's three checks of (T, means, w) against ``want``."""
    t_ref, m_ref, w_ref = want
    dt = t.double() - t_ref
    return {
        "t_gap_rel": float((dt.square().sum((0, 2)).sqrt()
                            / t_ref.square().sum((0, 2)).sqrt()).max()),
        "tv_mean_gap_sigma_w": float((weights.double()
                                      * ((means.double() - m_ref).abs()
                                         / var.double().sqrt()).amax(1)
                                      ).sum()),
        "ivector_gap_rel": float(((w.double() - w_ref).norm(dim=1)
                                  / w_ref.norm(dim=1)).max()),
    }


def _tv_chained_gaps(device, sessions):
    """Two chained ``tv_em_iteration`` calls (``speakerChunk`` 64, minimum
    divergence) at K = 2,048, D = 60, R = 400 from ``init_t`` at 0.001;
    for each, the gaps of the port and of ``tests/plain_ref/tv_em.py`` in
    float32 (TF32 off) to the reference in float64, all three from the
    call's input model."""
    from lia_ral_tpu_torch.fa import tv
    from plain_ref import tv_em as ref

    gmm, var, stats = _tv_statistics(device, sessions=sessions)
    model = tv.init_t(torch.Generator(device=device).manual_seed(1),
                      400, gmm, scale=0.001)
    out_gaps = []
    for _ in range(2):
        out, w = tv.tv_em_iteration(stats, model, chunk=64, min_div=True)
        want = ref.em_iteration(stats.n, stats.f, model.t.double(),
                                model.ubm_means.double(), var.double())
        f32 = ref.em_iteration(stats.n, stats.f, model.t.float(),
                               model.ubm_means.float(), var.float())
        out_gaps.append((_tv_gaps(out.t, out.ubm_means, w, want,
                                  gmm.weights, var),
                         _tv_gaps(*f32, want, gmm.weights, var)))
        model = out
    return out_gaps


def test_tv_em_iteration_matches_the_float64_reference(cuda_device):
    """At 4,096 sessions' statistics the port is within the TV cell's
    limits (read from its workload file) of the float64 reference after
    each of two chained passes: T after the pass, the means, each
    session's i-vector."""
    limits = _tv_limits()
    for port, _ in _tv_chained_gaps(cuda_device, 4096):
        for name, gap in port.items():
            assert gap <= limits[name], (name, gap)


def test_tv_em_iteration_with_fewer_sessions_than_rank_is_float32s_equal(
        cuda_device):
    """At 128 sessions, fewer than R = 400, the first M-step's T spans only
    the sessions' i-vectors (C = Σ w F̄ᵀ has rank S), so the second pass's
    L_s has R − S eigenvalues of 1 beside very large ones and float32
    itself moves T and the i-vectors far more than at the cell's size.
    Each of the port's gaps to the float64 reference stays within the
    cell's limit or within 4× the float32 reference's own gap (TF32 off)
    from the same input model."""
    limits = _tv_limits()
    for port, f32 in _tv_chained_gaps(cuda_device, 128):
        for name, gap in port.items():
            assert gap <= max(limits[name], 4 * f32[name]), \
                (name, gap, f32[name])
