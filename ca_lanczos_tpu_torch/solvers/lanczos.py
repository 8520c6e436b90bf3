"""Standard symmetric Lanczos with four (re)orthogonalization strategies.

Counterpart of ``ca_lanczos_tpu/solvers/lanczos.py`` (reference
lanczos.m).  The three-term step is tensor ops on the operator's device;
the host loop owns alpha/beta bookkeeping, the omega roundoff recurrence
(periodic mode) and Ritz monitoring (selective mode).

Orth modes (lanczos.m:26-31):
* local     — plain three-term recurrence;
* full      — each new vector is re-projected against all previous
              (lanczos.m:62-66,112-114; projection only, no renormalize);
* periodic  — omega-recurrence roundoff model, reorthogonalize the last 7
              vectors when max omega >= sqrt(eps) (lanczos.m:248-255);
* selective — monitor converged Ritz pairs via beta*|Vp[j,i]| <
              ||A|| sqrt(eps) and orthogonalize new vectors against them
              (lanczos.m:146-185).

The basis is stored row-major as (maxiter+1, n) so each Lanczos vector is
a contiguous row; ``LanczosResult.Q`` is its (n, maxiter) transpose view.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.config import Orth
from ca_lanczos_tpu_torch.ops.orth import project_and_normalize
from ca_lanczos_tpu_torch.ops.spmv import Operator, normest, spmv
from ca_lanczos_tpu_torch.utils.diagnostics import (
    OmegaRecurrence,
    orth_error_last,
    ritz_residual_norms,
)

_SQRT_EPS = float(np.sqrt(np.finfo(np.float64).eps))


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
    n = r.shape[0]
    q = r / torch.linalg.norm(r)
    dtype = q.dtype
    Q = torch.zeros((maxiter + 1, n), dtype=dtype, device=q.device)
    Q[0] = q
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)

    rnorm_hist = [] if diagnostics else None
    orth_hist = [] if diagnostics else None
    n_reorth = 0

    omega = OmegaRecurrence(normest(A)) if orth == Orth.PERIODIC else None
    norm_sqrt_eps = normest(A) * _SQRT_EPS if orth == Orth.SELECTIVE else None
    QR: Optional[torch.Tensor] = None  # converged Ritz basis (selective)
    nritz = 0

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

        elif orth == Orth.SELECTIVE:
            # Track converged Ritz pairs and orthogonalize against them
            # (lanczos.m:164-185).
            T = _tridiag(alpha[:j], beta[:j])
            d, Vp = np.linalg.eigh(T)
            conv = [i for i in range(j) if beta[i] * abs(Vp[j - 1, i]) < norm_sqrt_eps]
            if len(conv) > nritz:
                n_reorth += 1
                nritz = len(conv)
                Vc = torch.as_tensor(Vp[:, conv], dtype=dtype, device=Q.device)
                QR = Q[:j].T @ Vc
            if nritz > 0 and QR is not None:
                Q[j] = project_and_normalize([QR], Q[j], reorth=False).Q

        elif orth == Orth.PERIODIC:
            # omega roundoff recurrence (lanczos.m:248-255).
            omega.update(alpha[:j], beta[:j])
            if j > 1 and omega.max_error_scalar() >= _SQRT_EPS:
                n_reorth += 1
                lo = max(0, j - 6)
                prev = [Q[:lo].T] if lo > 0 else []
                res = project_and_normalize(prev, Q[lo : j + 1].T, reorth=True)
                Q[lo : j + 1] = res.Q.T
                omega.reset_scalar()

        if diagnostics:
            T = _tridiag(alpha[:j], beta[:j])
            d, Vp = np.linalg.eigh(T)
            row = np.zeros(maxiter)
            row[:j] = ritz_residual_norms(A, Q[:j].T, Vp, d)
            rnorm_hist.append(row)
            orth_hist.append(orth_error_last(Q[: j + 1].T))

    return LanczosResult(
        T=_tridiag(alpha, beta),
        Q=Q[:maxiter].T,
        alpha=alpha,
        beta=beta,
        ritz_rnorm=np.asarray(rnorm_hist) if diagnostics else None,
        orth_err=np.asarray(orth_hist) if diagnostics else None,
        n_reorth=n_reorth,
    )
