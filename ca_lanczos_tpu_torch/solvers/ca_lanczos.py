"""Communication-avoiding Lanczos (Hoemmen-style), reference ca_lanczos.m.

Counterpart of ``ca_lanczos_tpu/solvers/ca_lanczos.py``.  Per outer
iteration: one matrix-powers block of s SpMVs (K1 on a real DIA operator
on the card, ``ops.matrix_powers``), one block orthogonalization against
the previous s+1 basis vectors (tall-skinny GEMMs + TSQR, ``ops.orth``),
and O(s^2) host math recovering the tridiagonal block from the R factors
(``solvers._block``).  The basis is kept as (s*t+1, n) rows, each vector
contiguous; ``CaLanczosResult.Q`` is its (n, s*t) transposed view.

Orth modes (ca_lanczos.m:74-81):
* local     — orthogonalize each block against the previous block only;
* full      — local pass (R factors feed Tk), then a second
              projectAndNormalize against the whole basis
              (ca_lanczos.m:191-197);
* periodic  — blocked omega recurrence; when max omega >= sqrt(eps),
              reorthogonalize the current s+1 vectors against all previous
              (ca_lanczos.m:430-446);
* selective — track converged Ritz vectors, orthogonalize each new block
              against them (ca_lanczos.m:248-359).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.basis.leja import leja
from ca_lanczos_tpu_torch.basis.newton import newton_basis_matrix
from ca_lanczos_tpu_torch.config import Basis, LejaVariant, Orth, OrthParams
from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers
from ca_lanczos_tpu_torch.ops.orth import normalize, project_and_normalize
from ca_lanczos_tpu_torch.ops.spmv import Operator, normest
from ca_lanczos_tpu_torch.solvers._block import block_T, extend_T, first_block_T
from ca_lanczos_tpu_torch.solvers.lanczos import lanczos
from ca_lanczos_tpu_torch.utils.diagnostics import (
    OmegaRecurrence,
    orth_error_block,
    ritz_residual_norms,
)

_SQRT_EPS = float(np.sqrt(np.finfo(np.float64).eps))


def monomial_basis_matrix(s: int) -> np.ndarray:
    """Bk for the monomial basis: I(s+1)[:, 1:] (ca_lanczos.m:63-65)."""
    return np.eye(s + 1)[:, 1:]


def newton_shifts_bootstrap(
    A: Operator,
    q: torch.Tensor,
    s: int,
    orth: Orth = Orth.FULL,
    leja_variant: LejaVariant = LejaVariant.REAL,
) -> np.ndarray:
    """Run 2s steps of standard Lanczos, Leja-order eig(T) and build Bk
    (ca_lanczos.m:66-72).  The reference's ``leja(eigs,'nonmodified')``
    call executes the real/modified path (leja.m:23-31), hence REAL."""
    boot = lanczos(A, q, 2 * s, orth)
    basis_eigs = np.linalg.eigvalsh(boot.T)
    shifts = leja(basis_eigs, leja_variant)
    return newton_basis_matrix(shifts, s, modified=True)


def build_basis_matrix(
    A: Operator,
    q: torch.Tensor,
    s: int,
    basis: Basis,
    bootstrap_orth: Orth = Orth.FULL,
) -> np.ndarray:
    basis = Basis(basis)
    if basis == Basis.MONOMIAL:
        return monomial_basis_matrix(s)
    return newton_shifts_bootstrap(A, q, s, bootstrap_orth)


@dataclasses.dataclass
class CaLanczosResult:
    T: np.ndarray  # (s*t, s*t) projection matrix
    Q: torch.Tensor  # (n, s*t) basis
    Bk: np.ndarray
    beta: np.ndarray  # per-block betas; beta[t-1] is the trailing one
    ritz_rnorm: Optional[np.ndarray] = None
    orth_err: Optional[np.ndarray] = None
    n_reorth: int = 0

    @property
    def T_ext(self) -> np.ndarray:
        m = self.T.shape[0]
        out = np.zeros((m + 1, m))
        out[:m] = self.T
        out[m, m - 1] = self.beta[-1]
        return out


def ca_lanczos(
    A: Operator,
    r: torch.Tensor,
    s: int,
    total_steps: int,
    basis: Basis = Basis.MONOMIAL,
    orth: Orth = Orth.LOCAL,
    diagnostics: bool = False,
    params: OrthParams = OrthParams(),
    Bk: Optional[np.ndarray] = None,
) -> CaLanczosResult:
    """CA-Lanczos driver (ca_lanczos.m:24-86).

    total_steps is the Krylov dimension; t = ceil(total_steps / s) outer
    iterations are performed (ca_lanczos.m:52).
    """
    orth = Orth(orth)
    basis = Basis(basis)
    t = int(np.ceil(total_steps / s))

    q = r / torch.linalg.norm(r)
    if Bk is None:
        Bk = build_basis_matrix(A, q, s, basis)

    n = q.shape[0]
    dtype = q.dtype
    Q = torch.zeros((t * s + 1, n), dtype=dtype, device=q.device)  # rows
    b = np.zeros(t)
    T: Optional[np.ndarray] = None

    rnorm_hist: List[np.ndarray] = []
    orth_hist: List[float] = []
    n_reorth = 0

    omega = OmegaRecurrence(normest(A)) if orth == Orth.PERIODIC else None
    norm_sqrt_eps = normest(A) * _SQRT_EPS if orth == Orth.SELECTIVE else None
    QR: Optional[torch.Tensor] = None
    nritz = 0

    for k in range(1, t + 1):
        qk = Q[(k - 1) * s] if k > 1 else q
        V = matrix_powers(A, qk, s, Bk, basis)

        if k == 1:
            Qb, Rk, _ = normalize(V, params=params)
            Q[: s + 1] = Qb.T
            T, b[0] = first_block_T(Rk, Bk, s)
        else:
            blocks = [Q[(k - 2) * s : (k - 1) * s + 1].T]
            if orth == Orth.SELECTIVE and nritz > 0 and QR is not None:
                blocks.append(QR)
            res = project_and_normalize(blocks, V[:, 1 : s + 1], reorth=True, params=params)
            Q[(k - 1) * s + 1 : k * s + 1] = res.Q[:, :s].T
            Rkk_s = res.R_blocks[0]
            Rk_s = res.R

            if orth == Orth.FULL:
                # Extra full pass against the whole previous basis
                # (ca_lanczos.m:196-197); R factors are not reused.
                res2 = project_and_normalize(
                    [Q[: (k - 1) * s + 1].T], Q[(k - 1) * s + 1 : k * s + 1].T,
                    reorth=True, params=params,
                )
                Q[(k - 1) * s + 1 : k * s + 1] = res2.Q.T

            Tk, b[k - 1], _ = block_T(Rkk_s, Rk_s, Bk, b[k - 2], s)
            T = extend_T(T, Tk, b[k - 2], b[k - 1], s)

        if orth == Orth.SELECTIVE:
            # Converged-Ritz tracking (ca_lanczos.m:317-336).
            d, Vp = np.linalg.eigh(T[: s * k, : s * k])
            conv = [i for i in range(s * k) if b[k - 1] * abs(Vp[s * k - 1, i]) < norm_sqrt_eps]
            if len(conv) > nritz:
                n_reorth += 1
                nritz = len(conv)
                Vc = torch.as_tensor(Vp[:, conv], dtype=dtype, device=Q.device)
                QR, _, _ = normalize(Q[: s * k].T @ Vc, params=params)

        elif orth == Orth.PERIODIC:
            # Blocked omega recurrence (ca_lanczos.m:430-446).
            alpha = np.diagonal(T[: s * k, : s * k]).copy()
            beta_sub = np.diagonal(T[: s * k + 1, : s * k], -1).copy()
            omega.update(alpha, beta_sub)
            if k > 1 and omega.max_error_block(s) >= _SQRT_EPS:
                n_reorth += 1
                lo = (k - 1) * s
                res = project_and_normalize([Q[:lo].T], Q[lo : k * s + 1].T, reorth=True,
                                            params=params)
                Q[lo : k * s + 1] = res.Q.T
                omega.reset_block(s)

        if diagnostics:
            d, Vp = np.linalg.eigh(T[: s * k, : s * k])
            row = np.zeros(t * s)
            row[: s * k] = ritz_residual_norms(A, Q[: s * k].T, Vp, d)
            rnorm_hist.append(row)
            orth_hist.append(orth_error_block(Q[: s * k + 1].T, s))

    return CaLanczosResult(
        T=T[: s * t, : s * t],
        Q=Q[: s * t].T,
        Bk=Bk,
        beta=b,
        ritz_rnorm=np.asarray(rnorm_hist) if diagnostics else None,
        orth_err=np.asarray(orth_hist) if diagnostics else None,
        n_reorth=n_reorth,
    )
