"""The C-SVC model of one solve by the host formulas, in numpy and apart
from the port: what ``backend.svm.svm_train`` must give from the same α,
kernel matrix and bounds, on any device.  No JAX and no torch, so that the
card's tests import it too."""

from __future__ import annotations

import numpy as np


def default_c64(x: np.ndarray) -> float:
    """LIA's getC, C = 1/mean‖x‖², with float64 products and sums."""
    x = np.asarray(x, np.float64)
    return float(1.0 / max(np.mean(np.sum(x * x, axis=1)), 1e-12))


def host_model(x, y, alpha, k, c_vec, c, centre=None):
    """(support, alpha_y, bias, margin vectors) of the solve whose float32
    ``alpha`` was found on kernel matrix ``k`` under the bounds ``c_vec``:

    α at or under 1e-6·``c`` is 0; yᵀα = 0 is restored over the free
    vectors (0 < α < C) in float64; α·y in float32; the bias is the mean
    of y − K(α·y) over the free vectors, or over all where there are
    none, in float64; the support rows are the raw rows of x; with a
    ``centre`` (the linear kernel, solved on x less it) the bias takes
    −w·centre, w = supportᵀ(α·y), in float64."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    y64 = y.astype(np.float64)
    c_vec = np.asarray(c_vec, np.float32)
    alpha = np.asarray(alpha, np.float32).astype(np.float64)
    keep = alpha > 1e-6 * c
    alpha[~keep] = 0.0
    on_margin = keep & (alpha < c_vec * (1 - 1e-6))
    if on_margin.any():
        alpha[on_margin] -= (alpha @ y64) * y64[on_margin] / on_margin.sum()
    ay = alpha.astype(np.float32) * y
    resid = y64 - np.asarray(k, np.float64) @ ay.astype(np.float64)
    bias = resid[on_margin].mean() if on_margin.any() else resid.mean()
    support, alpha_y = x[keep], ay[keep]
    if centre is not None:
        bias -= alpha_y.astype(np.float64) @ (
            support.astype(np.float64) @ np.asarray(centre, np.float64))
    return support, alpha_y, float(bias), int(on_margin.sum())
