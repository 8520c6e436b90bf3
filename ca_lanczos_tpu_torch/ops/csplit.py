"""Complex linear algebra on the real/imag-split representation.

Counterpart of ``ca_lanczos_tpu/ops/csplit.py``.  A complex (n,) vector
rides as two real rows [re, im]; a complex (n, m) multivector as (m, 2, n)
rows.  The public functions take and return JAX's layout, (n, 2, m), as
views: ``X.permute(2, 1, 0)`` of the row storage, so a caller that keeps
rows (``solvers.propagators``) hands them in and gets rows back without a
copy.  The Gram and update products are real GEMMs on the block's device;
the small complex m x m factors live on the host as numpy complex128.

Used by the split CA propagator (``solvers.propagators.ca_lanczos_prop_split``):
the reference's projectAndNormalize on complex Krylov blocks
(ca_lanczos_prop.m:67-86) decomposes into these Gram/update products.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _rows(X: torch.Tensor) -> torch.Tensor:
    """(n, 2, m) -> its (m, 2, n) rows (a view)."""
    return X.permute(2, 1, 0)


def split_gram(Q: torch.Tensor, X: torch.Tensor) -> np.ndarray:
    """R = Q^H X for split multivectors Q (n,2,m), X (n,2,p) -> complex
    (m, p) on the host (one read).  Re R = Qre.Xre + Qim.Xim;
    Im R = Qre.Xim - Qim.Xre."""
    Qr, Xr = _rows(Q), _rows(X)
    re = Qr[:, 0] @ Xr[:, 0].T + Qr[:, 1] @ Xr[:, 1].T
    im = Qr[:, 0] @ Xr[:, 1].T - Qr[:, 1] @ Xr[:, 0].T
    R = torch.stack([re, im]).cpu().numpy().astype(np.float64)
    return R[0] + 1j * R[1]


def _matmul_rows(Xr: torch.Tensor, M: np.ndarray) -> torch.Tensor:
    """Rows (p, 2, n) of X @ (Mr + i Mi) for rows Xr (m, 2, n), M (m, p)."""
    Mr = torch.as_tensor(np.ascontiguousarray(M.real.T), dtype=Xr.dtype, device=Xr.device)
    Mi = torch.as_tensor(np.ascontiguousarray(M.imag.T), dtype=Xr.dtype, device=Xr.device)
    return torch.stack([Mr @ Xr[:, 0] - Mi @ Xr[:, 1], Mi @ Xr[:, 0] + Mr @ Xr[:, 1]], dim=1)


def split_project(Q: torch.Tensor, X: torch.Tensor, passes: int = 1
                  ) -> Tuple[torch.Tensor, np.ndarray]:
    """Block CGS of split X against split-orthonormal Q; returns
    (Y (n, 2, p), accumulated complex R)."""
    R = np.zeros((Q.shape[2], X.shape[2]), np.complex128)
    Yr = _rows(X)
    for _ in range(passes):
        Rp = split_gram(Q, Yr.permute(2, 1, 0))
        Yr = Yr - _matmul_rows(_rows(Q), Rp)
        R = R + Rp
    return Yr.permute(2, 1, 0), R


def split_cholqr(X: torch.Tensor, passes: int = 2) -> Tuple[torch.Tensor, np.ndarray]:
    """Cholesky QR of a split multivector: G = X^H X (hermitian, host
    complex), R = chol(G), Q = X R^{-1}; ``passes`` iterations for
    orthogonality (CholQR2 default), with a few-ulp diagonal shift when a
    Cholesky breaks down.  Returns (Q (n, 2, m), complex R)."""
    m = X.shape[2]
    eps = float(torch.finfo(X.dtype).eps)
    R_acc = np.eye(m, dtype=np.complex128)
    Qr = _rows(X)
    for _ in range(passes):
        G = split_gram(Qr.permute(2, 1, 0), Qr.permute(2, 1, 0))
        G = (G + G.conj().T) / 2
        tr = float(np.real(np.trace(G)))
        try:
            L = np.linalg.cholesky(G)
        except np.linalg.LinAlgError:
            L = np.linalg.cholesky(G + 11 * (m + 1) * eps * tr * np.eye(m))
        R = L.conj().T
        Qr = _matmul_rows(Qr, np.linalg.inv(R))
        R_acc = R @ R_acc
    return Qr.permute(2, 1, 0), R_acc
