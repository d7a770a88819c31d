"""Logical operations of total-variability training (one EM iteration of
``fa.tv.tv_em_iteration``), as functions of the cell's shapes alone
(``benchmark/flops.py`` holds the card's peaks).

Each logical product is counted once, a multiply-add as two operations,
whatever the program computes again or skips by symmetry:

* per session: L = I + Σ_c n_c E_c (2·K·R²) and A_c += n_c (L⁻¹ + wwᵀ)
  (2·K·R²), T Σ⁻¹ F̄ (2·K·D·R) and C += w F̄ᵀ (2·K·D·R), the Cholesky
  factor of L (R³/3) and L⁻¹ from it (2R³/3);
* per pass: E_c = T_c Σ_c⁻¹ T_cᵀ (2·K·R²·D), the M-step's K solves
  A_c⁻¹ C_c (an LU of 2R³/3 and 2R²·D for the D right-hand sides each)
  and the minimum divergence (T ← LᵀT, 2·R²·K·D, and Σ_w's Cholesky,
  R³/3).

No kernel of the port's own runs here (cuBLAS and cuSOLVER do the work),
so no byte count and no roofline share go with these.
"""

from __future__ import annotations


def session_flops(k: int, d: int, r: int) -> float:
    """One session's E-step: 4·K·R² + 4·K·D·R + R³."""
    return 4.0 * k * r * r + 4.0 * k * d * r + float(r) ** 3


def pass_fixed_flops(k: int, d: int, r: int) -> float:
    """A pass's work that does not grow with the sessions: E_c, the
    M-step and the minimum divergence."""
    e_c = 2.0 * k * r * r * d
    m_step = k * (2.0 * r ** 3 / 3.0 + 2.0 * r * r * d)
    min_div = 2.0 * r * r * k * d + r ** 3 / 3.0
    return e_c + m_step + min_div


def pass_flops(sessions: int, k: int, d: int, r: int) -> float:
    """One EM iteration over ``sessions`` sessions."""
    return sessions * session_flops(k, d, r) + pass_fixed_flops(k, d, r)
