"""K2 (per-utterance Baum-Welch stats) in the arithmetic modes beyond the
four tiers: the plain versions against the JAX package's Pallas kernel in
interpret mode on the same numpy inputs, the aliases of the tiers, the
six-pass logits against float64, ``"bf16sr"`` keyed on the global frame
index (so K2's utterances and K1's flat frames draw the same bits), and
``fa.stats``'s batch entry points, which take every ``stats_pass``.  The
budgets are those of tests/test_torch_kernel_modes_k1.py (its docstring
says why): 2e-6 of scale, and for a product that rounds p or xa·s once,
the median within it and every element within 2e-3 of scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lia_ral_tpu.gmm.pallas_kernels import bw_stats_fused as jbw_fused

from lia_ral_tpu_torch.fa import stats as tstats
from lia_ral_tpu_torch.gmm import cuda_kernels as ck

from _torch_parity import both_gmms, np_of
from test_torch_kernel_modes_k1 import (CASES, LLK_BUDGET, MODE_BUDGET,
                                        _assert_scaled)


def _utterances(rng, s, t, d, keep=0.7):
    x = rng.standard_normal((s, t, d)).astype(np.float32)
    mask = (rng.random((s, t)) < keep).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("name,tkw,jkw", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("t", [70, 61])
def test_k2_mode_plain_matches_jax_kernel(rng, t, name, tkw, jkw):
    """The port's plain K2 in each mode against the Pallas kernel in the
    same mode (interpret mode; T off the JAX block, ragged masks, an
    all-zero-weight utterance): n and f within the module's budgets, the
    weighted llk within 1e-6 relative (1e-3 absolute for the empty
    utterance's 0)."""
    jg, tg = both_gmms(rng, 16, 5)
    x, mask = _utterances(rng, 3, t, 5)
    mask[1] = 0.0
    got = ck.bw_stats_reference(torch.from_numpy(x), torch.from_numpy(mask),
                                tg, batch=2, **tkw)
    want = jbw_fused(jnp.asarray(x), jnp.asarray(mask), jg, interpret=True,
                     **jkw)
    mode = ck.check_mode(**tkw)
    once = mode.stats in ("1", "2p", "2x")
    _assert_scaled(got[0], want[0], MODE_BUDGET, f"{name} n",
                   flips=once and not mode.nx)
    _assert_scaled(got[1], want[1], MODE_BUDGET, f"{name} f", flips=once)
    np.testing.assert_allclose(np_of(got[2]), np_of(want[2]),
                               rtol=LLK_BUDGET, atol=1e-3)
    assert torch.all(got[0][1] == 0) and torch.all(got[1][1] == 0)
    assert float(got[2][1]) == 0.0


def test_k2_tier_spellings_are_one_mode(rng):
    """``mxu_precision="default"`` gives fastMath's K2 to the digit, and
    ``"high"`` the default tier's, in every exponential mode."""
    _, tg = both_gmms(rng, 16, 7)
    x, mask = _utterances(rng, 4, 50, 7)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    for exp_mode in ("exp2", "exp", "fast2"):
        fm = ck.bw_stats_fused(xt, mt, tg, compute_dtype=torch.bfloat16,
                               exp_mode=exp_mode)
        dflt = ck.bw_stats_fused(xt, mt, tg, mxu_precision="default",
                                 exp_mode=exp_mode)
        base = ck.bw_stats_fused(xt, mt, tg, exp_mode=exp_mode)
        high = ck.bw_stats_fused(xt, mt, tg, mxu_precision="high",
                                 exp_mode=exp_mode)
        assert all(torch.equal(a, b) for a, b in zip(fm, dflt))
        assert all(torch.equal(a, b) for a, b in zip(base, high))


def test_k2_highest_is_closer_to_float64(rng):
    """K2 at ``mxu_precision="highest"`` (six-pass logits and stats) sits
    closer to float64 Baum-Welch stats than the default tier, in n and f."""
    _, tg = both_gmms(rng, 16, 7)
    x, mask = _utterances(rng, 3, 90, 7)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    x64 = x.astype(np.float64)
    ci = np_of(tg.cov_inv).astype(np.float64)
    m = np_of(tg.means).astype(np.float64)
    cst = (-0.5 * (7 * np.log(2 * np.pi) - np.log(ci).sum(-1))
           - 0.5 * (m * m * ci).sum(-1)
           + np.log(np_of(tg.weights).astype(np.float64)))
    ld = -0.5 * (x64 ** 2) @ ci.T + x64 @ (m * ci).T + cst
    g = np.exp(ld - ld.max(-1, keepdims=True))
    g = g / g.sum(-1, keepdims=True) * mask[..., None]
    n64, f64 = g.sum(1), np.einsum("stk,std->skd", g, x64)
    high = ck.bw_stats_reference(xt, mt, tg, mxu_precision="highest")
    default = ck.bw_stats_reference(xt, mt, tg)
    for i, want in ((0, n64), (1, f64)):
        assert (np.abs(np_of(high[i]) - want).max()
                < np.abs(np_of(default[i]) - want).max())


def test_k2_sr_draws_the_bits_of_k1s_flat_frames(rng):
    """``"bf16sr"`` keys a frame of K2 as utterance·T + t, the index K1
    gives the same frame of the flattened batch: K2's stats summed over
    utterances equal K1's on the flat frames up to f32 reordering (1e-6
    of scale), whatever K2's batch (1 or 3 utterances at a time); the same
    seed reproduces to the digit and another differs."""
    _, tg = both_gmms(rng, 16, 5)
    x, mask = _utterances(rng, 3, 64, 5)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    kw = dict(stats_pass="bf16sr", seed=9)
    k1 = ck.em_stats_reference(xt.reshape(-1, 5), mt.reshape(-1), tg,
                               chunk=50, **kw)
    for batch in (1, 3):
        n, f, _ = ck.bw_stats_reference(xt, mt, tg, batch=batch, **kw)
        _assert_scaled(n.sum(0), k1.n, 1e-6, f"n batch {batch}")
        _assert_scaled(f.sum(0), k1.sum_x, 1e-6, f"f batch {batch}")
    n1, f1, l1 = ck.bw_stats_fused(xt, mt, tg, **kw)
    n2, f2, l2 = ck.bw_stats_fused(xt, mt, tg, **kw)
    assert torch.equal(n1, n2) and torch.equal(f1, f2)
    n3, f3, _ = ck.bw_stats_fused(xt, mt, tg, stats_pass="bf16sr", seed=10)
    assert not torch.equal(f3, f1)


@pytest.mark.parametrize("stats_pass", ck.STATS_PASSES)
def test_bw_stats_entry_points_take_every_stats_pass(rng, stats_pass,
                                                    monkeypatch):
    """``bw_stats_batch`` (kernel or plain, here plain) and
    ``bw_stats_bucketed`` pass any ``stats_pass`` of the kernel through,
    as the JAX functions do: the batch equal to the digit to
    ``bw_stats_reference`` in that mode; each bucketed row within 1e-6 of
    scale of that utterance alone (its zero-weight padding adds exact
    zeros), rows in input order, every batch call in that mode.
    ``"bf16sr"`` keys its bits on the padded batch's frames, so its
    bucketed rows are checked for the mode alone."""
    seen = []
    batch_fn = tstats.bw_stats_batch

    def spy(*args, **kwargs):
        seen.append(kwargs.get("stats_pass"))
        return batch_fn(*args, **kwargs)

    monkeypatch.setattr(tstats, "bw_stats_batch", spy)
    _, tg = both_gmms(rng, 8, 5)
    x, mask = _utterances(rng, 4, 40, 5)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    n, f, _ = ck.bw_stats_reference(xt, mt, tg, stats_pass=stats_pass)
    for use_fused in (None, False):
        st = tstats.bw_stats_batch(xt, mt, tg, use_fused=use_fused,
                                   stats_pass=stats_pass)
        assert torch.equal(st.n, n) and torch.equal(st.f, f)
    seen.clear()
    entries = [(x[i, :30 + 3 * i], mask[i, :30 + 3 * i]) for i in range(4)]
    got = tstats.bw_stats_bucketed(entries, tg, bucket=16, batch_size=2,
                                   stats_pass=stats_pass)
    for i, (xi, mi) in enumerate(entries):
        ni, fi, _ = ck.bw_stats_reference(torch.from_numpy(xi)[None],
                                          torch.from_numpy(mi)[None], tg,
                                          stats_pass=stats_pass)
        if stats_pass != "bf16sr":
            _assert_scaled(got.n[i], ni[0], 1e-6, f"bucketed n {i}")
            _assert_scaled(got.f[i], fi[0], 1e-6, f"bucketed f {i}")
    assert len(seen) == 3 and set(seen) == {stats_pass}    # 32; 48 x 2, 48
