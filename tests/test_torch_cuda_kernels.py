"""The CUDA kernels K1 (em_stats_fused) and K2 (bw_stats_fused) of the
PyTorch port against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device.  This file imports neither jax nor the JAX package, so it also
runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX's CPU platform.)

Tolerances: the JAX suite's CPU budgets (tests/test_pallas_kernel.py
:35-46) with the atol scaled by the array's max — n rtol 1e-4, atol
1e-4·max n; sums rtol 1e-3, atol 1e-3·max|·| — since K=2048 sums over
tens of thousands of frames are O(10³); llk rel 1e-5.  The fastStats
tiers' S/F: 2e-3·max|·| (a bf16 rounding of p or xa·s flips on an
f32-level difference between the kernel's and the plain version's
logits).  The fastMath tier rounds its operands at the same points as
its plain version and keeps the default budgets.  A tier's kernel must
also sit closer to its own plain version than to the default tier's, so
that rounding at other points would show.
"""

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.convert import gmm_from_numpy
from lia_ral_tpu_torch.gmm import cuda_kernels as ck
from lia_ral_tpu_torch.gmm.kernels import EmStats

from _torch_parity import cuda_device, np_of, random_gmm_np

pytestmark = pytest.mark.cuda


def _gmm(seed, k, d, device):
    return gmm_from_numpy(*random_gmm_np(np.random.default_rng(seed), k, d),
                          device=device)


def _close(got, want, rtol):
    got, want = np_of(got), np_of(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.mark.parametrize("n,k,d,chunk", [(65536, 2048, 39, 8192),
                                         (1000, 37, 13, 256),
                                         (777, 64, 60, 100),
                                         (2000, 3, 1, 8192),
                                         (10000, 2048, 39, 8192)])
def test_k1_cuda_matches_plain(cuda_device, n, k, d, chunk):
    rng = np.random.default_rng(5)
    tg = _gmm(1, k, d, cuda_device)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0.0
    xt, wt = x.to(cuda_device), torch.from_numpy(w).to(cuda_device)
    before = ck.launch_counts["em_stats_fused"]
    got = ck.em_stats_fused(xt, wt, tg, chunk=chunk)
    torch.cuda.synchronize()
    assert isinstance(got, EmStats)
    assert ck.launch_counts["em_stats_fused"] == before + 1
    want = ck.em_stats_reference(xt, wt, tg)
    _close(got.n, want.n, 1e-4)
    _close(got.sum_x, want.sum_x, 1e-3)
    _close(got.sum_xx, want.sum_xx, 1e-3)
    np.testing.assert_allclose(float(got.llk), float(want.llk), rtol=1e-5)
    np.testing.assert_allclose(float(got.count), float(want.count),
                               rtol=1e-6)
    # fixed-order reduction, no atomics: a rerun reproduces every digit
    again = ck.em_stats_fused(xt, wt, tg, chunk=chunk)
    for a, b in zip((again.n, again.sum_x, again.sum_xx, again.llk),
                    (got.n, got.sum_x, got.sum_xx, got.llk)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s,t,k,d", [(8, 2000, 2048, 39), (5, 2060, 64, 39),
                                     (7, 61, 100, 13)])
def test_k2_cuda_matches_plain(cuda_device, s, t, k, d):
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


TIERS = [(None, "bf16nx", "fastStats"), (torch.bfloat16, "x3", "fastMath"),
         (torch.bfloat16, "bf16nx", "fastMath+fastStats")]


def _tier_sum_rtol(stats_pass):
    return 2e-3 if stats_pass == "bf16nx" else 1e-3


def _closer_to_tier(got, tier_plain, default_plain):
    """Mean |error| (a rare bf16 rounding flip moves one element by a whole
    ulp, so the max would not separate the tiers at small T)."""
    got, a, b = np_of(got), np_of(tier_plain), np_of(default_plain)
    assert np.mean(np.abs(got - a)) < 0.5 * np.mean(np.abs(got - b))


@pytest.mark.parametrize("cdt,sp,name", TIERS, ids=[t[2] for t in TIERS])
@pytest.mark.parametrize("n,k,d,chunk", [(65536, 2048, 39, 8192),
                                         (777, 64, 60, 100)])
def test_k1_tiers_cuda_match_plain(cuda_device, n, k, d, chunk, cdt, sp,
                                   name):
    rng = np.random.default_rng(7)
    tg = _gmm(1, k, d, cuda_device)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0.0
    xt, wt = x.to(cuda_device), torch.from_numpy(w).to(cuda_device)
    key = f"em_stats_fused[{name}]"
    before = ck.launch_counts[key]
    got = ck.em_stats_fused(xt, wt, tg, chunk=chunk, compute_dtype=cdt,
                            stats_pass=sp)
    torch.cuda.synchronize()
    assert ck.launch_counts[key] == before + 1
    want = ck.em_stats_reference(xt, wt, tg, compute_dtype=cdt,
                                 stats_pass=sp)
    _close(got.n, want.n, 1e-4)
    _close(got.sum_x, want.sum_x, _tier_sum_rtol(sp))
    _close(got.sum_xx, want.sum_xx, _tier_sum_rtol(sp))
    np.testing.assert_allclose(float(got.llk), float(want.llk), rtol=1e-5)
    np.testing.assert_allclose(float(got.count), float(want.count),
                               rtol=1e-6)
    _closer_to_tier(got.sum_x, want.sum_x,
                    ck.em_stats_reference(xt, wt, tg).sum_x)
    again = ck.em_stats_fused(xt, wt, tg, chunk=chunk, compute_dtype=cdt,
                              stats_pass=sp)
    for a, b in zip((again.n, again.sum_x, again.sum_xx, again.llk),
                    (got.n, got.sum_x, got.sum_xx, got.llk)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cdt,sp,name", TIERS, ids=[t[2] for t in TIERS])
@pytest.mark.parametrize("s,t,k,d", [(8, 2000, 2048, 39), (7, 61, 100, 13)])
def test_k2_tiers_cuda_match_plain(cuda_device, s, t, k, d, cdt, sp, name):
    rng = np.random.default_rng(8)
    tg = _gmm(2, k, d, cuda_device)
    x = rng.standard_normal((s, t, d), dtype=np.float32)
    mask = (rng.random((s, t)) < 0.7).astype(np.float32)
    mask[-1] = 0.0                       # an all-zero-weight utterance
    xt = torch.from_numpy(x).to(cuda_device)
    mt = torch.from_numpy(mask).to(cuda_device)
    key = f"bw_stats_fused[{name}]"
    before = ck.launch_counts[key]
    n, f, llk = ck.bw_stats_fused(xt, mt, tg, compute_dtype=cdt,
                                  stats_pass=sp)
    torch.cuda.synchronize()
    assert ck.launch_counts[key] == before + 1
    rn, rf, rl = ck.bw_stats_reference(xt, mt, tg, compute_dtype=cdt,
                                       stats_pass=sp)
    _close(n, rn, 1e-4)
    _close(f, rf, _tier_sum_rtol(sp))
    np.testing.assert_allclose(np_of(llk), np_of(rl), rtol=1e-5)
    assert torch.all(n[-1] == 0) and torch.all(f[-1] == 0)
    assert float(llk[-1]) == 0.0
    _closer_to_tier(f, rf, ck.bw_stats_reference(xt, mt, tg)[1])
    n2, f2, l2 = ck.bw_stats_fused(xt, mt, tg, compute_dtype=cdt,
                                   stats_pass=sp)
    assert torch.equal(n2, n) and torch.equal(f2, f) and torch.equal(l2, llk)


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
