"""The operation and byte counts on shapes checked by hand."""

import pytest

from benchmark import flops


def test_k1_counts_each_product_once():
    # logits 2·N·K·(2D+1) and statistics the same again
    assert flops.k1_flops(1, 1, 1) == 12
    assert flops.k1_flops(10, 3, 2) == 4 * 10 * 3 * 5
    # x (N·D) and w (N) in, B (K·(2D+1)) in, stats (K·(2D+1)) and 2 out
    assert flops.k1_bytes(10, 3, 2) == 4 * (20 + 10 + 15 + 15 + 2)


def test_k1_at_the_cell_is_bound_by_operations():
    n, k, d = 8_400_000, 2048, 60
    assert flops.k1_flops(n, k, d) == pytest.approx(8.3263488e12, rel=1e-9)
    t, by = flops.least_seconds(flops.k1_flops(n, k, d),
                                flops.k1_bytes(n, k, d))
    assert by == "flops"
    assert t == pytest.approx(8.3263488e12 / 989e12, rel=1e-9)


def test_k2_counts_logits_and_first_order_stats():
    assert flops.k2_flops(1, 1, 1) == 2 * 3 + 2 * 2
    assert flops.k2_flops(100, 4, 3) == 2 * 100 * 4 * 7 + 2 * 100 * 4 * 4
    # frames and weights, B, then (n, F) and llk of each segment
    assert flops.k2_bytes(100, 2, 4, 3) == 4 * (300 + 100 + 28 + 32 + 2)


def test_extraction_counts():
    # S=K=D=R=1: L 2, TΣ⁻¹F̄ 2, Cholesky 1/3 + 2, E_c once 2
    assert flops.extraction_flops(1, 1, 1, 1) == pytest.approx(
        2 + 2 + 1 / 3 + 2 + 2)
    s, k, d, r = 2048, 2048, 60, 400
    per = 2 * k * r * r + 2 * k * d * r + r ** 3 / 3 + 2 * r * r
    assert flops.extraction_flops(s, k, d, r) == pytest.approx(
        s * per + 2 * k * r * r * d)


def test_least_time_takes_the_larger_bound():
    t, by = flops.least_seconds(1.0, flops.PEAK_HBM_BYTES)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = flops.least_seconds(flops.PEAK_BF16_FLOPS * 2, 1.0)
    assert by == "flops" and t == pytest.approx(2.0)
