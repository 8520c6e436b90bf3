"""Shared CA-Lanczos block small-math: the Tk-from-R-factors recurrence.

A copy of ``ca_lanczos_tpu/solvers/_block.py`` (numpy only; the port keeps
its own so that it never imports the JAX package).
``solvers.fused_restarted._block_T`` is its device mirror.

This is the correctness crux of CA-Lanczos (ca_lanczos.m:200-223 and its
duplicates in restarted_ca_lanczos.m:336-359, ca_lanczos_prop.m:91-114):
after block-orthogonalizing the new s basis vectors, the tridiagonal block
Tk is recovered purely from the small R factors:

    Tk = R Bk R^{-1} + (b_k / rho~) z_k e_s^T - beta_{k-1} e_1 e_s^T Rkk R^{-1}

All host float64 NumPy (O(s^2) work per outer iteration).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rdiv(X: np.ndarray, Y: np.ndarray, rcond=None) -> np.ndarray:
    """MATLAB X / Y == X @ inv(Y), via a solve.

    ``rcond`` switches to a pseudo-inverse solve (lstsq): used by the
    breakdown-recovery path, where a rank-deficient R must not amplify
    null directions into plausible-looking T entries — the pinv leaves
    them at zero, so spurious Ritz pairs keep large residuals and are
    never locked (normalize.m:28-51 recovery semantics).
    """
    if rcond is None:
        return np.linalg.solve(Y.T, X.T).T
    return np.linalg.lstsq(Y.T, X.T, rcond=rcond)[0].T


def first_block_T(
    Rk: np.ndarray, Bk: np.ndarray, s: int, rcond=None
) -> Tuple[np.ndarray, float]:
    """First-block T = Rk Bk / Rk[0:s,0:s], beta_1 = T[s, s-1]
    (ca_lanczos.m:178-182).  beta is real for the eigensolver path; the
    complex propagator path carries a (numerically) real value too."""
    T = _rdiv(np.asarray(Rk) @ np.asarray(Bk), np.asarray(Rk)[:s, :s], rcond)
    return T, float(np.real(T[s, s - 1]))


def block_T(
    Rkk_s: np.ndarray,
    Rk_s: np.ndarray,
    Bk: np.ndarray,
    b_prev: float,
    s: int,
    rcond=None,
) -> Tuple[np.ndarray, float, np.ndarray]:
    """Recover the next tridiagonal block Tk and beta_k from the R factors
    of projectAndNormalize (ca_lanczos.m:200-214).

    Rkk_s: (s+1, s) projection coefficients of V[:, 1:s+1] against the
        previous basis block (R_blocks[0] of project_and_normalize).
    Rk_s: (s, s) normalization R factor.
    Returns (Tk (s, s), beta_k, Rk (s+1, s+1) assembled R).
    """
    # Promote to float64/complex128 (complex path feeds the propagators,
    # ca_lanczos_prop.m:91-114; their T is taken real at the end).
    wide = np.result_type(np.float64, np.asarray(Rkk_s).dtype, np.asarray(Rk_s).dtype)
    Rkk_s = np.asarray(Rkk_s, dtype=wide)
    Rk_s = np.asarray(Rk_s, dtype=wide)
    Bk = np.asarray(Bk, dtype=np.result_type(np.float64, np.asarray(Bk).dtype))

    # Rkk = [0 | Rkk_s[0:s, :]]  (s x (s+1));  Rk = [e1 | [Rkk_s[s, :]; Rk_s]]
    # ((s+1) x (s+1))  (ca_lanczos.m:201-202).
    Rkk = np.hstack([np.zeros((s, 1), wide), Rkk_s[:s, :]])
    Rk = np.zeros((s + 1, s + 1), wide)
    Rk[0, 0] = 1.0
    Rk[0, 1:] = Rkk_s[s, :s]
    Rk[1:, 1:] = Rk_s

    zk = Rk[:s, s]
    rho = Rk[s, s]
    rho_t = Rk[s - 1, s - 1]
    bk = float(Bk[s, s - 1])  # 1 for the monomial basis (ca_lanczos.m:206)
    Rs = Rk[:s, :s]

    e1 = np.zeros(s)
    e1[0] = 1.0
    es = np.zeros(s)
    es[s - 1] = 1.0

    main = _rdiv(Rs @ Bk[:s, :], Rs, rcond)
    corr = (bk / rho_t) * np.outer(zk, es)
    last_row = _rdiv(Rkk[:s, :s][s - 1 : s, :], Rs, rcond)  # e_s^T Rkk R^{-1}
    Tk = main + corr - b_prev * np.outer(e1, last_row[0])

    beta_k = bk * (rho / rho_t)
    return Tk, float(np.real(beta_k)), Rk


def extend_T(T_prev: np.ndarray, Tk: np.ndarray, b_prev: float, b_k: float, s: int) -> np.ndarray:
    """Grow the extended ((m+1) x m) tridiagonal matrix by one s-block
    (ca_lanczos.m:217-223): couple blocks through b_{k-1}, append Tk, and
    place b_k on the new trailing row."""
    m = T_prev.shape[1]
    out = np.zeros((m + s + 1, m + s), np.result_type(T_prev.dtype, Tk.dtype))
    out[:m, :m] = T_prev[:m, :m]
    out[m - 1, m] = b_prev
    out[m, m - 1] = b_prev
    out[m : m + s, m : m + s] = Tk
    out[m + s, m + s - 1] = b_k
    return out
