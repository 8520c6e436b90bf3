"""The distributed CA-Lanczos block step.

Counterpart of ``ca_lanczos_tpu/parallel/step.py``.  One call is one outer
CA iteration's device work on every rank:

    halo exchange  ->  s local products (K1 / K3 / K4,   [matrix powers]
                       or the ELL / BSR product)
    all-reduced Gram + 2x block CGS  ->  TSQR            [block orth]

The O(s^2) T assembly from the replicated R factors stays on the host
(``solvers._block``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.parallel.dist_bsr import DistBsr, _bsr_powers_local
from ca_lanczos_tpu_torch.parallel.dist_ell import DistEll, _ell_powers_local
from ca_lanczos_tpu_torch.parallel.dist_orth import local_project, local_qr, local_qr_safe
from ca_lanczos_tpu_torch.parallel.dist_pell import DistPell, _pell_powers_local
from ca_lanczos_tpu_torch.parallel.distributed import (
    DistDia,
    _coefs,
    _powers_local,
    check_s_bound,
    ilv_pad_state,
    ilv_padded_powers,
    ilv_unpad_state,
    ilv_zero_ghosts,
)
from ca_lanczos_tpu_torch.parallel.mesh import Mesh

# The local powers of each operator on the natural (row) state: one halo
# exchange + s local steps -> rows (s+1, n_local), or (s, n_local) with
# include_q=False.
_LOCAL_ROWS = {
    DistDia: _powers_local,
    DistEll: _ell_powers_local,
    DistPell: _pell_powers_local,
    DistBsr: _bsr_powers_local,
}


def partition_operator(A, mesh: Mesh, s_max: int, dist_format: str = "auto"):
    """This rank's block of a host operator, as the JAX package partitions
    it (one rule for every distributed driver):

    * DiaMatrix -> DistDia, on the interleaved engine with
      ``dist_format="ilv"`` (which raises when the shard admits no
      interleaved layout);
    * EllMatrix -> DistPell with ``dist_format="pell"`` (K4 on the rank's
      window), refused for "ilv", else DistEll;
    * BsrMatrix -> DistBsr, refused for "ilv" and "pell";
    * a distributed operator passes through."""
    from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, EllMatrix

    if isinstance(A, tuple(_LOCAL_ROWS)):
        return A
    if isinstance(A, BsrMatrix):
        if dist_format in ("ilv", "pell"):
            raise ValueError(
                f"dist_format={dist_format!r} is not a BSR engine; block operators "
                "distribute as DistBsr (dist_format='auto')")
        return DistBsr.from_bsr(A, mesh, s_max=s_max)
    if isinstance(A, EllMatrix):
        if dist_format == "pell":
            return DistPell.from_ell(A, mesh, s_max=s_max)
        if dist_format == "ilv":
            raise ValueError(
                "dist_format='ilv' is the banded-DIA interleaved engine; this operator is "
                "an EllMatrix: use dist_format='pell' (K4 local step) or 'auto'")
        return DistEll.from_ell(A, mesh, s_max=s_max)
    if isinstance(A, DiaMatrix):
        if dist_format == "ilv":
            Ad = DistDia.from_dia(A, mesh, s_max=s_max, ilv=True)
            if Ad.ilv_data is None:
                raise ValueError(
                    "dist_format='ilv': shard shape admits no interleaved "
                    "layout (need f32, n_local % 1024 == 0, s*w <= 1024)")
            return Ad
        return DistDia.from_dia(A, mesh, s_max=s_max)
    raise TypeError(
        f"cannot distribute operator of type {type(A).__name__}; pass a "
        "DiaMatrix, EllMatrix or BsrMatrix (route raw matrices via "
        "parallel.auto.route_dist_operator)")


def local_rows(A, x_local: torch.Tensor, coefs: np.ndarray, s: int, mesh: Mesh,
               include_q: bool = True) -> torch.Tensor:
    """The natural-state powers rows of any distributed operator (see
    ``_LOCAL_ROWS``)."""
    return _LOCAL_ROWS[type(A)](A, x_local, coefs, s, mesh, include_q=include_q)


def _powers(A, x_local: torch.Tensor, coefs: np.ndarray, s: int,
            mesh: Mesh) -> torch.Tensor:
    """[x, p_1(A)x, ..., p_s(A)x] as this rank's (state_len, s+1) block (a
    transposed view of rows), for every distributed operator and engine
    (the JAX package's ``_local_powers_fn``).

    Interleaved engine: x is ghost-zero padded-domain state; the kernel
    runs in the planes' dtype (the state may be wider: the IRL's f64), the
    output ghosts are re-zeroed so the Gram all-reduce sees each global
    row once, and the rows return in the state's dtype."""
    check_s_bound(A, s)
    if A.ilv_engine:
        V2, _ = ilv_padded_powers(A, x_local, coefs, s, mesh)
        ilv_zero_ghosts(A, V2)
        return torch.cat([x_local[None, :], V2.to(x_local.dtype)], dim=0).T
    return local_rows(A, x_local, coefs, s, mesh).T


def orth_qr(A, X: torch.Tensor, qr_method: str, mp: bool, mesh: Mesh,
            safe: bool = False, key: int = 0):
    """``local_qr`` (``local_qr_safe`` with ``safe``, which also returns the
    rank) of a state block.  On the interleaved engine the QR sees the
    centre rows alone and Q returns with exactly zero ghosts: a
    Householder QR of a block with zero rows leaves eps*cond(X) in them,
    which the next ghost refresh would drop from the Krylov recurrence
    (in f32 the restarted driver then stalls where the natural engine
    converges: tests/test_torch_dist_ilv.py)."""
    if not A.ilv_engine:
        return (local_qr_safe(X, qr_method, key=key, mp=mp, mesh=mesh) if safe
                else local_qr(X, qr_method, mp, mesh))
    out = (local_qr_safe(ilv_unpad_state(A, X), qr_method, key=key, mp=mp, mesh=mesh)
           if safe else local_qr(ilv_unpad_state(A, X), qr_method, mp, mesh))
    return (ilv_pad_state(A, out[0]),) + tuple(out[1:])


def newton_coeffs(Bk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Three-term coefficients (diag, sup) from a change-of-basis matrix Bk
    ((s+1) x s, unit subdiagonal): V[:,k+1] = (A - diag[k]) V[:,k] -
    sup[k] V[:,k-1].  Monomial Bk gives zeros (ca_lanczos.m:63-65)."""
    Bk = np.asarray(Bk, dtype=np.float64)
    s = Bk.shape[1]
    diag = np.diagonal(Bk)[:s].copy()
    sup = np.zeros(s)
    if s > 1:
        sup[1:] = np.diagonal(Bk, 1)[: s - 1]
    return diag, sup


def dist_first_block(A, q: torch.Tensor, diag, sub, s: int, mesh: Mesh,
                     qr_method: str = "tsqr", mp: bool = False):
    """First CA block: V = powers(q); [Q, R] = TSQR(V) (ca_lanczos.m:176-182).
    Returns (Q (state_len, s+1), R (s+1, s+1) host f64)."""
    V = _powers(A, q, _coefs(diag, sub, s), s, mesh)
    return orth_qr(A, V, qr_method, mp, mesh)


def dist_ca_block(A, Q_prev: torch.Tensor, diag, sub, s: int, mesh: Mesh,
                  qr_method: str = "tsqr", mp: bool = False):
    """One CA block k>1 (ca_lanczos.m:185-214, device part): powers from
    Q_prev's last column, two CGS passes against Q_prev, TSQR.  Returns
    (Q_new (state_len, s), Rkk (s+1, s), R (s, s)); Rkk and R are host f64,
    the inputs of ``solvers._block.block_T``."""
    V = _powers(A, Q_prev[:, -1], _coefs(diag, sub, s), s, mesh)
    Y, Rkk = local_project(Q_prev, V[:, 1:], passes=2, mp=mp, mesh=mesh)
    Q_new, R = orth_qr(A, Y, qr_method, mp, mesh)
    return Q_new, Rkk, R
