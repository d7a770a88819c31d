"""Kernels K1 (EM stats) and K2 (per-utterance Baum-Welch stats) of the
PyTorch port: their plain versions against the JAX package's Pallas
kernels run in interpret mode (the JAX suite's own CPU route) and
against its XLA stats paths.  The CUDA kernels themselves are held
against these plain versions in tests/test_torch_cuda_kernels.py.

Tolerances: the JAX suite's CPU budgets (tests/test_pallas_kernel.py
:35-46 and :153-163) — n rtol/atol 1e-4, sums rtol/atol 1e-3, llk rel
1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lia_ral_tpu.fa import stats as jstats
from lia_ral_tpu.gmm import kernels as jk
from lia_ral_tpu.gmm.pallas_kernels import bw_stats_fused as jbw_fused
from lia_ral_tpu.gmm.pallas_kernels import em_stats_fused as jem_fused

from lia_ral_tpu_torch.fa import stats as tstats
from lia_ral_tpu_torch.gmm import cuda_kernels as ck

from _torch_parity import (LLK_RTOL, N_TOL, SUM_TOL, assert_em_stats_close,
                           both_gmms, np_of)


def _frames(rng, n, d, zero_frac=0.05):
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < zero_frac] = 0.0
    return x, w


def _utterances(rng, s, t, d, keep=0.7):
    x = rng.standard_normal((s, t, d)).astype(np.float32)
    mask = (rng.random((s, t)) < keep).astype(np.float32)
    return x, mask


def _assert_bw_close(got, want):
    """(n, f[, llk]) tuples of either package."""
    np.testing.assert_allclose(np_of(got[0]), np_of(want[0]), **N_TOL)
    np.testing.assert_allclose(np_of(got[1]), np_of(want[1]), **SUM_TOL)
    if len(got) > 2 and len(want) > 2:
        np.testing.assert_allclose(np_of(got[2]), np_of(want[2]),
                                   rtol=LLK_RTOL, atol=1e-3)


# -- K1 plain version ------------------------------------------------------

@pytest.mark.parametrize("n,k,d", [(96, 8, 5), (130, 16, 7), (45, 4, 3)])
def test_k1_plain_matches_jax_kernel_and_xla(rng, n, k, d):
    """n = 130 and 45 are not multiples of the JAX block (32): the JAX
    wrapper pads them with zero-weight frames, the port needs none."""
    jg, tg = both_gmms(rng, k, d)
    x, w = _frames(rng, n, d)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    got = ck.em_stats_reference(torch.from_numpy(x), torch.from_numpy(w), tg,
                                chunk=32)
    assert_em_stats_close(got, jem_fused(xj, wj, jg, block=32,
                                         interpret=True))
    assert_em_stats_close(got, jk.em_stats(xj, wj, jg))


def test_k1_wrapper_on_cpu_is_the_plain_version(rng):
    _, tg = both_gmms(rng, 16, 7)
    x, w = _frames(rng, 200, 7)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = dict(ck.launch_counts)
    got = ck.em_stats_fused(xt, wt, tg)
    assert ck.launch_counts == before
    want = ck.em_stats_reference(xt, wt, tg)
    for a, b in zip((got.n, got.sum_x, got.sum_xx, got.llk, got.count),
                    (want.n, want.sum_x, want.sum_xx, want.llk, want.count)):
        assert torch.equal(a, b)


def test_k1_zero_weights_contribute_nothing(rng):
    """Zero-weight frames add exactly 0: stats of the weighted frames
    alone equal stats of all frames."""
    _, tg = both_gmms(rng, 8, 5)
    x, w = _frames(rng, 150, 5, zero_frac=0.3)
    keep = w > 0
    all_ = ck.em_stats_reference(torch.from_numpy(x), torch.from_numpy(w), tg)
    sel = ck.em_stats_reference(torch.from_numpy(x[keep]),
                                torch.from_numpy(w[keep]), tg)
    assert_em_stats_close(all_, sel)


# -- K2 plain version ------------------------------------------------------

def test_k2_plain_matches_jax_kernel_and_xla(rng):
    jg, tg = both_gmms(rng, 16, 7)
    x, mask = _utterances(rng, 5, 70, 7)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    got = ck.bw_stats_reference(torch.from_numpy(x), torch.from_numpy(mask),
                                tg, batch=2)
    _assert_bw_close(got, jbw_fused(xj, mj, jg, block=32, interpret=True))
    ref = jstats.bw_stats_batch(xj, mj, jg, use_fused=False)
    _assert_bw_close(got, (ref.n, ref.f))
    # llk row: weighted per-utterance log-likelihood
    want = [float(jnp.sum(jk.frame_llk(xj[i], jg) * mj[i])) for i in range(5)]
    np.testing.assert_allclose(np_of(got[2]), want, rtol=LLK_RTOL)


@pytest.mark.parametrize("t", [64, 61, 2060])
def test_k2_plain_ragged_lengths(rng, t):
    """T as in the JAX suite's block-path test: one exact block, a
    non-aligned length, and longer than one JAX block."""
    jg, tg = both_gmms(rng, 16, 5)
    x, mask = _utterances(rng, 3, t, 5)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    got = tstats.bw_stats_batch(torch.from_numpy(x), torch.from_numpy(mask),
                                tg)
    want = jbw_fused(xj, mj, jg, block=32, interpret=True)
    _assert_bw_close((got.n, got.f), want)
    ref = jstats.bw_stats_batch(xj, mj, jg, use_fused=False)
    _assert_bw_close((got.n, got.f), (ref.n, ref.f))


def test_k2_all_zero_weight_utterance(rng):
    jg, tg = both_gmms(rng, 8, 5)
    x, mask = _utterances(rng, 4, 40, 5)
    mask[2] = 0.0
    n, f, llk = ck.bw_stats_fused(torch.from_numpy(x),
                                  torch.from_numpy(mask), tg)
    assert torch.all(n[2] == 0) and torch.all(f[2] == 0)
    assert float(llk[2]) == 0.0
    assert all(torch.isfinite(a).all() for a in (n, f, llk))
    want = jbw_fused(jnp.asarray(x), jnp.asarray(mask), jg, block=32,
                     interpret=True)
    _assert_bw_close((n, f, llk), want)


@pytest.mark.parametrize("use_fused", [None, True, False])
def test_bw_stats_batch_on_cpu_is_plain(rng, use_fused):
    _, tg = both_gmms(rng, 8, 5)
    x, mask = _utterances(rng, 3, 33, 5)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    before = dict(ck.launch_counts)
    got = tstats.bw_stats_batch(xt, mt, tg, use_fused=use_fused)
    assert ck.launch_counts == before
    n, f, _ = ck.bw_stats_reference(xt, mt, tg)
    assert torch.equal(got.n, n) and torch.equal(got.f, f)
    # one utterance through the single-utterance path
    n0, f0 = tstats.accumulate_bw_stats(xt[0], mt[0], tg)
    np.testing.assert_allclose(np_of(n0), np_of(n[0]), **N_TOL)
    np.testing.assert_allclose(np_of(f0), np_of(f[0]), **SUM_TOL)


def test_bw_stats_bucketed_matches_jax(rng):
    jg, tg = both_gmms(rng, 8, 4)
    entries = []
    for t in (30, 70, 45, 130, 12):
        x = rng.standard_normal((t, 4)).astype(np.float32)
        m = (rng.random(t) > 0.2).astype(np.float32)
        entries.append((x, m))
    got = tstats.bw_stats_bucketed(entries, tg, bucket=64, batch_size=2)
    want = jstats.bw_stats_bucketed(entries, jg, bucket=64, batch_size=2)
    _assert_bw_close((got.n, got.f), (want.n, want.f))
    with pytest.raises(ValueError):
        tstats.bw_stats_bucketed([], tg)


def test_bw_stats_container_matches_jax(rng):
    jg, tg = both_gmms(rng, 8, 4)
    n = rng.random((3, 8)).astype(np.float32) * 10
    f = rng.standard_normal((3, 8, 4)).astype(np.float32)
    ts = tstats.BwStats(torch.from_numpy(n), torch.from_numpy(f))
    js = jstats.BwStats(jnp.asarray(n), jnp.asarray(f))
    assert ts.merge(ts).n_utts == 6
    np.testing.assert_allclose(np_of(ts.centered(tg.means)),
                               np_of(js.centered(jg.means)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        np_of(ts.normalized(tg.means, tg.cov_inv)),
        np_of(js.normalized(jg.means, jg.cov_inv)), rtol=1e-6, atol=1e-6)


def test_kernel_params_give_the_logits(rng):
    """The (2D+1, K) matrix the wrapper hands the kernels: the augmented
    design [x², x, 1] times it is log(w_k·N_k(x)), as the TPU kernel's B."""
    from lia_ral_tpu_torch.gmm.kernels import weighted_logdens

    _, tg = both_gmms(rng, 16, 7)
    x = torch.from_numpy(rng.standard_normal((50, 7)).astype(np.float32))
    bt = ck.kernel_params(tg)
    assert bt.shape == (15, 16) and bt.is_contiguous()
    xa = torch.cat([x * x, x, torch.ones((50, 1))], dim=1)
    np.testing.assert_allclose(np_of(xa @ bt), np_of(weighted_logdens(x, tg)),
                               rtol=1e-5, atol=1e-4)
