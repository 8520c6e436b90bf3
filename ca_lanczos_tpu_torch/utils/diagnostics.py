"""Convergence and orthogonality diagnostics.

Counterpart of ``ca_lanczos_tpu/utils/diagnostics.py``.  The reference
computes these inside the drivers (lanczos.m:68-83, ca_lanczos.m:88-107);
here they are one shared module.  Ritz residuals and Gram products are
tensor ops on the basis' device; the omega roundoff recurrence (Simon's
estimate) is O((st)^2) host float64 math, copied from the JAX package.

The orthogonality errors take a basis (n, k) or a sequence of such blocks
(their side-by-side concatenation, whose Gram is assembled block by block
so that no tall copy is made).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.spmv import Operator, spmv

Blocks = Union[torch.Tensor, Sequence[torch.Tensor]]


def ritz_residual_norms(A: Operator, Q: torch.Tensor, Vp, d) -> np.ndarray:
    """Relative Ritz residuals ||A x - l x|| / ||l x||, in descending-
    eigenvalue order (lanczos.m:68-77, ca_lanczos.m:88-97)."""
    d = np.asarray(d)
    order = np.argsort(d)[::-1]
    Vp_t = torch.as_tensor(np.ascontiguousarray(np.asarray(Vp)[:, order]), dtype=Q.dtype,
                           device=Q.device)
    d_t = torch.as_tensor(np.ascontiguousarray(d[order]), dtype=Q.dtype, device=Q.device)
    X = Q @ Vp_t  # Ritz vectors (n, m)
    num = torch.linalg.norm(spmv(A, X) - X * d_t[None, :], dim=0)
    den = torch.abs(d_t) * torch.linalg.norm(X, dim=0)
    return (num / den).cpu().numpy()


def _gram(Q: Blocks) -> torch.Tensor:
    blocks = [Q] if isinstance(Q, torch.Tensor) else list(Q)
    return torch.cat([torch.cat([a.conj().T @ b for b in blocks], dim=1) for a in blocks],
                     dim=0)


def orth_error_fro(Q: Blocks) -> float:
    """||I - Q^H Q||_F (restarted_ca_lanczos.m:166-167)."""
    G = _gram(Q)
    return float(torch.linalg.norm(G - torch.eye(G.shape[0], dtype=G.dtype, device=G.device)))


def orth_error_last(Q: torch.Tensor) -> float:
    """max(Q[:, :j-1]^H Q[:, j]) for the newest vector (lanczos.m:79-83).

    Note: the reference takes the (signed) max, not max-abs; preserved.
    """
    j = Q.shape[1]
    if j < 2:
        return 0.0
    return float(torch.max((Q[:, : j - 1].conj().T @ Q[:, j - 1]).real))


def orth_error_block(Q: torch.Tensor, s: int) -> float:
    """Block orthogonality error (ca_lanczos.m:99-107): max |Q_old^H Q_new|
    between all-but-last-block and the last s+1 columns."""
    j = Q.shape[1]
    if j > s + 1:
        G = Q[:, : j - s - 1].conj().T @ Q[:, j - s - 1 :]
        return float(torch.max(torch.abs(G)))
    G = Q.conj().T @ Q
    return float(torch.max(torch.abs(G - torch.eye(j, dtype=G.dtype, device=G.device))))


class OmegaRecurrence:
    """Simon's omega-recurrence estimate of orthogonality loss (a copy of
    the JAX package's class).

    One implementation serves both the scalar form (one new row per
    Lanczos step, lanczos.m:267-311) and the blocked form (s new rows per
    CA block, ca_lanczos.m:469-539): ``update`` extends the (m+1)x(m+1)
    estimate matrix until it covers len(alpha)+1 rows, given the full
    alpha (diag T) and beta (subdiag T, including the trailing block beta)
    histories.

    omega[j, k] estimates |q_j^T q_k| (1-indexed rows/cols in the math;
    stored 0-indexed).
    """

    def __init__(self, anorm: float, eps: Optional[float] = None):
        self.t = (np.finfo(np.float64).eps if eps is None else eps) * anorm
        self.omega: Optional[np.ndarray] = None

    def _seed(self, beta1: float) -> None:
        om = np.zeros((2, 2))
        om[0, 0] = 1.0
        om[0, 1] = 0.0
        om[1, 0] = self.t / beta1
        om[1, 1] = 1.0
        self.omega = om

    def update(self, alpha, beta) -> np.ndarray:
        """Extend to cover n = len(alpha) steps (n+1 rows)."""
        a = np.asarray(alpha, dtype=np.float64)
        b = np.asarray(beta, dtype=np.float64)
        n = len(a)
        T = self.t

        if self.omega is None:
            self._seed(b[0])
        m = self.omega.shape[0] - 1  # steps currently covered
        if n + 1 <= self.omega.shape[0]:
            return self.omega

        om = np.zeros((n + 1, n + 1))
        om[: m + 1, : m + 1] = self.omega

        # Extend rows j+1 for j = m+1 .. n (1-indexed step j).
        for j in range(m + 1, n + 1):
            binv = 1.0 / b[j - 1]
            # k = 1 (no omega[j, k-1] term).
            w = b[1] * om[j - 1, 1] + (a[0] - a[j - 1]) * om[j - 1, 0] - b[j - 1] * om[j - 2, 0]
            om[j, 0] = binv * (w + T) if w > 0 else binv * (w - T)
            # k = 2 .. j-1.
            for k in range(2, j):
                w = (
                    b[k] * om[j - 1, k]
                    + (a[k - 1] - a[j - 1]) * om[j - 1, k - 1]
                    + b[k - 1] * om[j - 1, k - 2]
                    - b[j - 1] * om[j - 2, k - 1]
                )
                om[j, k - 1] = binv * (w + T) if w > 0 else binv * (w - T)
            om[j, j - 1] = binv * T
            om[j, j] = 1.0

        self.omega = om
        return om

    def max_error_scalar(self) -> float:
        """Scalar-form trigger value: max |omega[n+1, 1:n]| (lanczos.m:250)."""
        om = self.omega
        n = om.shape[0] - 1
        return float(np.max(np.abs(om[n, :n]))) if n >= 1 else 0.0

    def max_error_block(self, s: int) -> float:
        """Blocked trigger (ca_lanczos.m:434-441): max over the last s rows
        i of max |omega[row, 1:row-1]|."""
        om = self.omega
        n = om.shape[0] - 1
        err = 0.0
        for i in range(s):
            row = n - s + 1 + i  # 1-indexed row (row+1 in MATLAB terms)
            err = max(err, float(np.max(np.abs(om[row, :row]))))
        return err

    def reset_scalar(self) -> None:
        """Scalar reset after reorthogonalization (lanczos.m:302-311)."""
        om = self.omega
        n = om.shape[0] - 1
        om[n - 1, :n] = self.t
        om[n, :n] = self.t
        om[n - 1, n - 1] = 1.0
        om[n - 1, n] = 0.0
        om[n, n] = 1.0

    def reset_block(self, s: int) -> None:
        """Blocked reset (ca_lanczos.m:541-551): last s rows set to T with
        unit diagonal."""
        om = self.omega
        m = om.shape[0] - s - 1
        for j in range(m + 1, m + s + 1):
            om[j, :j] = self.t
            om[j, j] = 1.0
