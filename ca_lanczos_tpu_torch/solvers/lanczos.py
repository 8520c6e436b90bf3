"""Standard symmetric Lanczos (reference lanczos.m).

Counterpart of ``ca_lanczos_tpu/solvers/lanczos.py`` for the two orth
modes the banded main path runs (the Newton bootstrap and the solver
probe both use ``Orth.FULL``):

* local — plain three-term recurrence;
* full  — each new vector is re-projected against all previous
          (lanczos.m:62-66,112-114; projection only, no renormalize).

``Orth.PERIODIC`` / ``Orth.SELECTIVE`` and ``diagnostics=True`` need the
port of ``ops/orth.py`` and ``utils/diagnostics.py`` (ROADMAP A.3/A.4)
and raise ``NotImplementedError`` until then.

The basis is stored row-major as (maxiter+1, n) so each Lanczos vector is
a contiguous row; ``LanczosResult.Q`` is its (n, maxiter) transpose view.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.config import Orth
from ca_lanczos_tpu_torch.ops.spmv import Operator, spmv


@dataclasses.dataclass
class LanczosResult:
    """T is the m x m tridiagonal; beta[m-1] is the next off-diagonal
    (the residual norm of the last step), needed by restarted drivers."""

    T: np.ndarray
    Q: torch.Tensor
    alpha: np.ndarray
    beta: np.ndarray
    ritz_rnorm: Optional[np.ndarray] = None
    orth_err: Optional[np.ndarray] = None
    n_reorth: int = 0

    @property
    def T_ext(self) -> np.ndarray:
        """(m+1) x m extended tridiagonal including the trailing beta row."""
        m = self.T.shape[0]
        out = np.zeros((m + 1, m))
        out[:m] = self.T
        out[m, m - 1] = self.beta[m - 1]
        return out


def _tridiag(alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    m = len(alpha)
    T = np.diag(alpha)
    if m > 1:
        T += np.diag(beta[: m - 1], 1) + np.diag(beta[: m - 1], -1)
    return T


def lanczos(A: Operator, r: torch.Tensor, maxiter: int, orth: Orth = Orth.LOCAL,
            diagnostics: bool = False) -> LanczosResult:
    """Symmetric Lanczos (lanczos.m:18-60)."""
    orth = Orth(orth)
    if orth in (Orth.PERIODIC, Orth.SELECTIVE):
        raise NotImplementedError(
            f"lanczos orth={orth.value!r} needs ops/orth.py and "
            "utils/diagnostics.py, not yet ported (ROADMAP A.3/A.4)"
        )
    if diagnostics:
        raise NotImplementedError(
            "lanczos diagnostics need utils/diagnostics.py, not yet ported (ROADMAP A.4)"
        )
    n = r.shape[0]
    q = r / torch.linalg.norm(r)
    Q = torch.zeros((maxiter + 1, n), dtype=q.dtype, device=q.device)
    Q[0] = q
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)

    for j in range(1, maxiter + 1):
        qj = Q[j - 1]
        # r = A q_j - beta_{j-1} q_{j-1}; alpha = <q_j, r>; r -= alpha q_j
        # (lanczos.m:103-110)
        w = spmv(A, qj)
        if j > 1:
            w = w - beta[j - 2] * Q[j - 2]
        a_j = torch.vdot(qj, w)
        w = w - a_j * qj
        b_j = torch.linalg.norm(w)
        Q[j] = w / b_j
        alpha[j - 1] = float(a_j.real)
        beta[j - 1] = float(b_j)
        if orth == Orth.FULL:
            # Re-project the new vector on all previous (lanczos.m:112-114).
            Qp = Q[:j]
            Q[j] = Q[j] - Qp.T @ (Qp.conj() @ Q[j])

    return LanczosResult(T=_tridiag(alpha, beta), Q=Q[:maxiter].T, alpha=alpha, beta=beta)
