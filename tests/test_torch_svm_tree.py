"""The algorithms of the SVM dual kernel (``csrc/svm_dual.cu``) on the CPU:
its bisection as 10 rounds of a 31-candidate tree, its warp
transpose-reduce, and the host-side plan of the wrapper.

The kernel itself runs only on the card (``tests/test_torch_cuda_kernels
.py``); here each algorithm is written in float32 torch or numpy and held
against the plain loop of ``backend/svm.py`` (the JAX ``_dual_solve`` op
for op) bit for bit, so that the kernel's rearrangement of the loop is
shown exact before any summation order enters.
"""

import numpy as np
import pytest
import torch

from lia_ral_tpu_torch.backend import svm


def _g(a, y, c, mid):
    """g(mid) as the plain loop sums it (``svm._project``)."""
    return torch.sum(torch.minimum(torch.clamp(a - mid * y, min=0.0), c) * y,
                     dim=-1, keepdim=True)


def _span(a, c):
    c_max = torch.amax(c, dim=-1, keepdim=True)
    return torch.amax(torch.abs(a), dim=-1, keepdim=True) + c_max + 1.0


def _loop_lambda(a, y, c):
    """The 50-step bisection of ``svm._project``; returns (lam, mids)."""
    span = _span(a, c)
    lo, hi, mids = -span, span, []
    for _ in range(svm.BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        mids.append(float(mid))
        pos = _g(a, y, c, mid) > 0.0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    return 0.5 * (lo + hi), mids


def _tree_lambda(a, y, c):
    """The kernel's bisection: 10 rounds; a round evaluates g at the 31
    midpoints of a complete tree of the next 5 levels (node h's children
    2h, 2h+1 halve its interval at its mid, computed as the loop computes
    it), then walks the tree from the root on the signs.  Returns (lam,
    the mids the walk visits)."""
    span = _span(a, c)
    lo, hi, visited = -span, span, []
    for _ in range(svm.BISECTION_STEPS // svm.TREE_LEVELS):
        lows, highs, sign = {1: lo}, {1: hi}, {}
        for h in range(1, 32):
            mid = 0.5 * (lows[h] + highs[h])
            if h < 16:
                lows[2 * h], highs[2 * h] = lows[h], mid
                lows[2 * h + 1], highs[2 * h + 1] = mid, highs[h]
            sign[h] = bool(_g(a, y, c, mid) > 0.0)
        h = 1
        for _ in range(svm.TREE_LEVELS):
            mid = 0.5 * (lo + hi)
            visited.append(float(mid))
            if sign[h]:
                lo = mid
            else:
                hi = mid
            h = 2 * h + int(sign[h])
    return 0.5 * (lo + hi), visited


def _case(kind, n, seed):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.3, 1.0, -1.0).astype(np.float32)
    c = np.full(n, 0.05 + rng.random(), np.float32)
    c[y > 0] *= np.float32(1.0 + 9.0 * rng.random())    # targetPenalty
    if kind == "random":
        a = rng.standard_normal(n).astype(np.float32) * c
    elif kind == "all clipped":          # every element at 0 or C
        a = (np.where(rng.random(n) < 0.5, -3.0, 4.0) * c).astype(np.float32)
    elif kind == "all free":             # every element strictly inside
        a = (c * (0.25 + 0.5 * rng.random(n))).astype(np.float32)
    else:                                # FISTA's own input: α + lr·grad
        a = (c * rng.random(n) + 1e-3 * rng.standard_normal(n)).astype(
            np.float32)
    return torch.from_numpy(a), torch.from_numpy(y), torch.from_numpy(c)


@pytest.mark.parametrize("kind", ["random", "all clipped", "all free",
                                  "fista"])
@pytest.mark.parametrize("n", [1, 2, 5, 31, 32, 33, 55, 64, 65, 232, 233,
                               300])
def test_tree_bisection_is_the_loops_bit_for_bit(kind, n):
    """On the same g-sums, the 10 rounds of 5 levels visit exactly the
    loop's 50 midpoints and give its λ to the bit, and so the projection
    ``svm._project`` gives."""
    a, y, c = _case(kind, n, seed=n)
    lam_loop, mids_loop = _loop_lambda(a, y, c)
    lam_tree, mids_tree = _tree_lambda(a, y, c)
    assert mids_tree == mids_loop
    assert lam_tree.view(torch.int32).item() == \
        lam_loop.view(torch.int32).item()
    alpha = torch.minimum(torch.clamp(a - lam_tree * y, min=0.0), c)
    assert torch.equal(alpha, svm._project(a, y, c))


def test_tree_rounds_cover_the_loop():
    assert svm.BISECTION_STEPS % svm.TREE_LEVELS == 0
    assert 2 ** svm.TREE_LEVELS - 1 == 31          # candidates a round


def _transpose_reduce(p):
    """The kernel's warp transpose-reduce on a (32 lanes, 32 values)
    array: five exchanges of 16, 8, 4, 2, 1 values with the lane at xor
    distance w (``keep + received``, in that order); lane c ends with
    the sum of candidate c over the lanes."""
    p = p.copy()
    lanes = np.arange(32)
    w = 16
    while w:
        up = (lanes & w) != 0
        send = np.where(up[:, None], p[:, :w], p[:, w:2 * w])
        keep = np.where(up[:, None], p[:, w:2 * w], p[:, :w])
        p[:, :w] = keep + send[lanes ^ w]
        w //= 2
    return p[:, 0]


@pytest.mark.parametrize("seed", range(4))
def test_transpose_reduce_gives_lane_c_candidate_c(seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((32, 32)).astype(np.float32)
    if seed == 3:
        p = np.round(p * 4) / 4               # exact sums: equal to numpy's
        np.testing.assert_array_equal(_transpose_reduce(p), p.sum(0))
    else:
        np.testing.assert_allclose(_transpose_reduce(p), p.sum(0),
                                   rtol=1e-5, atol=1e-5)


def test_row_stride_is_conflict_free():
    """A row of Q in shared memory takes a multiple of 4 floats whose
    quarter is odd: eight lanes' 16-byte reads of eight consecutive rows
    at the same column fall in eight different bank groups."""
    for cols in range(1, 600):
        s = svm.row_stride(cols)
        assert s >= cols and s % 4 == 0 and (s // 4) % 2 == 1
        assert s - cols < 8
        for q in (0, 3, 17):
            groups = {(r * (s // 4) + q) % 8 for r in range(8)}
            assert len(groups) == 8


@pytest.mark.parametrize("n,regime,cluster,threads", [
    (1, "one-warp", 1, 32), (31, "one-warp", 1, 32),
    (32, "one-warp", 1, 32), (33, "one-warp", 1, 32),
    (64, "one-warp", 1, 32), (65, "one-block", 1, 64),
    (128, "one-block", 1, 64), (129, "one-block", 1, 96),
    (svm.RESIDENT_LIMIT, "one-block", 1, 128),
    (svm.RESIDENT_LIMIT + 1, "cluster", 2, 64)])
def test_plan_at_the_resident_edges(n, regime, cluster, threads):
    plan = svm.solve_plan(n)
    assert (plan.regime, plan.cluster, plan.threads) == (regime, cluster,
                                                         threads)
    assert plan.resident and plan.smem <= svm.SMEM_BYTES
    assert plan.rows == -(-n // cluster) and 2 * plan.threads >= plan.rows


def test_resident_limit_is_the_last_n_that_fits():
    assert svm.RESIDENT_LIMIT == 232
    assert svm._resident_bytes(232, 232) <= svm.SMEM_BYTES
    assert svm._resident_bytes(233, 233) > svm.SMEM_BYTES


def _last_resident_cluster_n(max_cluster):
    n = svm.RESIDENT_LIMIT + 1
    while svm.solve_plan(n + 1, max_cluster).resident:
        n += 1
    return n


@pytest.mark.parametrize("max_cluster", [16, 8])
def test_plan_at_the_streaming_edge(max_cluster):
    """The last N whose slices fit the largest cluster stays resident; the
    next streams on that cluster in power-of-two tiles of at least 32
    columns whose two-stage ring fits beside the vector."""
    last = _last_resident_cluster_n(max_cluster)
    plan = svm.solve_plan(last, max_cluster)
    assert plan.regime == "cluster" and plan.cluster == max_cluster
    nxt = svm.solve_plan(last + 1, max_cluster)
    assert nxt.regime == "streaming" and nxt.cluster == max_cluster
    assert not nxt.resident and nxt.tile >= svm.MIN_TILE
    assert nxt.tile & (nxt.tile - 1) == 0
    assert nxt.vec_len % nxt.tile == 0 and nxt.vec_len >= last + 1
    assert nxt.vec_len // nxt.tile >= 2 and nxt.smem <= svm.SMEM_BYTES
    wider = 4 * (-(-(last + 1) // (2 * nxt.tile)) * 2 * nxt.tile
                 + svm.EXCHANGE_FLOATS + 2 * nxt.rows * (2 * nxt.tile + 4))
    assert wider > svm.SMEM_BYTES or 2 * nxt.tile >= last + 1


def test_plan_cluster_edges_the_card_tests_take():
    """The card tests' cluster shapes: N = 600 on 7 blocks, N = 928 the
    last that 16 blocks hold, N = 929 the first that streams."""
    assert svm.solve_plan(600).cluster == 7
    assert _last_resident_cluster_n(svm.MAX_CLUSTER) == 928
    assert svm.solve_plan(928).cluster == 16


@pytest.mark.parametrize("n", [1001, 4096, svm.MAX_VECTORS])
def test_plan_streams_the_large_problems(n):
    plan = svm.solve_plan(n)
    assert plan.regime == "streaming" and plan.cluster == svm.MAX_CLUSTER
    assert plan.rows * plan.cluster >= n
    assert plan.threads <= svm.MAX_THREADS and plan.smem <= svm.SMEM_BYTES


def test_plan_cluster_sizes_grow_with_n():
    """Above one block, the cluster is the smallest whose blocks hold
    their slices: never smaller for a larger N."""
    sizes = [svm.solve_plan(n).cluster for n in range(1, 1100, 7)]
    assert sizes == sorted(sizes)
    assert svm.solve_plan(900).cluster == 15


def test_plan_rejects_what_the_card_cannot_hold():
    with pytest.raises(ValueError, match="8192"):
        svm.solve_plan(svm.MAX_VECTORS + 1)
    with pytest.raises(ValueError, match="cluster"):
        svm.solve_plan(svm.MAX_VECTORS, max_cluster=8)
    with pytest.raises(ValueError):
        svm.solve_plan(0)
