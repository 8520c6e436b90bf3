"""Change-of-basis matrices for CA-Lanczos (reference ca_lanczos.m:61-72).

Counterpart of the basis helpers of ``ca_lanczos_tpu/solvers/ca_lanczos.py``
(``monomial_basis_matrix``, ``newton_shifts_bootstrap``,
``build_basis_matrix``).  The ``ca_lanczos`` driver itself is not ported
yet (ROADMAP A.4).
"""

from __future__ import annotations

import numpy as np
import torch

from ca_lanczos_tpu_torch.basis.leja import leja
from ca_lanczos_tpu_torch.basis.newton import newton_basis_matrix
from ca_lanczos_tpu_torch.config import Basis, LejaVariant, Orth
from ca_lanczos_tpu_torch.ops.spmv import Operator
from ca_lanczos_tpu_torch.solvers.lanczos import lanczos


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
