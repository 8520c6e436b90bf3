"""Distributed block orthogonalization: TSQR, CholQR, block CGS.

Counterpart of ``ca_lanczos_tpu/parallel/dist_orth.py``.  The rows are
sharded over the ranks and every reduction is one collective:

* ``local_tsqr`` — local thin QR, ``all_gather`` of the P small R factors,
  QR of the stacked (P*m, m) matrix, local Q correction;
* ``local_cholqr`` — Gram matrix by ``all_reduce``, Cholesky, local
  triangular solve;
* ``local_project`` — block classical Gram-Schmidt with all-reduced Gram
  products, two passes.

The replicated small factorizations (the stacked-R QR, the Cholesky, the
rank SVD) run in float64 numpy / CPU torch on every rank from identical
all-reduced or all-gathered bytes, so every rank holds bitwise the same
factors and takes the same decisions from them.  Replicated results come
back as host float64 numpy arrays; row blocks stay on the rank's device
in the block's dtype.

**Hierarchical meshes**: ``psum_rows`` reduces over the chip group first
and then the host group; ``local_tsqr`` builds a two-level R tree, chip
level (C*m x m) then host level (H*m x m).

Blocks are (n_local, m) tensors of any strides (the drivers hand in
transposed views of row-stored bases).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.parallel import comm
from ca_lanczos_tpu_torch.parallel.mesh import Mesh


def _f64(X: torch.Tensor) -> torch.Tensor:
    return X.to(torch.float64)


def psum_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over every rank (a new contiguous tensor); chip group
    first, then host group, on a hierarchical mesh."""
    x = x.contiguous().clone()
    if mesh.hierarchical:
        comm.all_reduce(x, mesh.chip_group)
        return comm.all_reduce(x, mesh.host_group)
    return comm.all_reduce(x)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _stack_qr(R: np.ndarray, device: torch.device, group, index: int) -> Tuple[np.ndarray, np.ndarray]:
    """One TSQR tree level over ``group``: gather every member's R, QR of
    the stack in f64; returns (this member's Q-correction block, next R)."""
    m = R.shape[1]
    parts = comm.all_gather(torch.as_tensor(np.ascontiguousarray(R), device=device), group)
    stacked = np.concatenate([p.cpu().numpy() for p in parts], axis=0)
    Qs, Rs = np.linalg.qr(stacked, mode="reduced")
    return Qs[index * m:(index + 1) * m], Rs


def local_tsqr(X_local: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, np.ndarray]:
    """TSQR over the ranks: X_local (n_local, m) -> (Q_local, R) with R
    replicated (host f64) and diag(R) >= 0 (tsqr.m:9-11).  The local QR is
    cuSOLVER's on the card; the stacked QR is f64 numpy."""
    Q1, R1 = torch.linalg.qr(X_local, mode="reduced")
    R1 = _host(R1)
    if mesh.hierarchical:
        Q2, R2 = _stack_qr(R1, X_local.device, mesh.chip_group, mesh.chip)
        Q3, R = _stack_qr(R2, X_local.device, mesh.host_group, mesh.host)
        Qc = Q2 @ Q3
    else:
        Qc, R = _stack_qr(R1, X_local.device, None, mesh.rank)
    sgn = np.where(np.diag(R) < 0, -1.0, 1.0)
    R = sgn[:, None] * R
    Qc = Qc * sgn[None, :]
    return Q1 @ torch.as_tensor(Qc, dtype=X_local.dtype, device=X_local.device), R


def _chol_host(G: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor of an all-reduced Gram matrix, computed on the
    CPU in G's dtype (``ops.qr._chol_safe``: escalating shifts on
    breakdown), identical on every rank."""
    from ca_lanczos_tpu_torch.ops.qr import _chol_safe

    return _chol_safe(G.cpu()).conj().T


def local_cholqr(X_local: torch.Tensor, mp: bool = False,
                 mesh: Mesh = None) -> Tuple[torch.Tensor, np.ndarray]:
    """CholQR over the ranks (cholqr.m:3-9): G = psum(X^T X), R = chol(G),
    Q = X R^{-1}.  ``mp``: Gram, Cholesky and solve in float64 while X and
    Q keep the storage dtype."""
    if mp and X_local.dtype != torch.float64:
        Xw = _f64(X_local)
        G = psum_rows(Xw.T @ Xw, mesh)
        R = _chol_host(G)
        Q = torch.linalg.solve_triangular(R.to(Xw.device), Xw, upper=True, left=False)
        return Q.to(X_local.dtype), _host(R)
    G = psum_rows(X_local.T @ X_local, mesh)
    R = _chol_host(G)
    Q = torch.linalg.solve_triangular(R.to(X_local.device), X_local, upper=True, left=False)
    return Q, _host(R)


def local_cholqr2(X_local: torch.Tensor, mp: bool = False,
                  mesh: Mesh = None) -> Tuple[torch.Tensor, np.ndarray]:
    """Two distributed CholQR passes."""
    Q1, R1 = local_cholqr(X_local, mp, mesh)
    Q2, R2 = local_cholqr(Q1, mp, mesh)
    return Q2, R2 @ R1


def local_tsqr_mp(X_local: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, np.ndarray]:
    """local_tsqr in float64; Q returns in X's dtype."""
    Q, R = local_tsqr(_f64(X_local), mesh)
    return Q.to(X_local.dtype), R


def local_qr(X_local: torch.Tensor, qr_method: str = "tsqr", mp: bool = False,
             mesh: Mesh = None):
    """Dispatch on a ``config.QrMethod`` value (+ mixed precision)."""
    from ca_lanczos_tpu_torch.config import QrMethod

    mp = mp and X_local.dtype != torch.float64
    if QrMethod(qr_method) == QrMethod.CHOLQR2:
        return local_cholqr2(X_local, mp, mesh)
    return local_tsqr_mp(X_local, mesh) if mp else local_tsqr(X_local, mesh)


def local_qr_safe(X_local: torch.Tensor, qr_method: str = "tsqr", key: int = 0,
                  rank_tol: float = 1.0e-12, mp: bool = False, mesh: Mesh = None):
    """Rank-revealing local_qr with null-space randomization on
    catastrophic breakdown (normalize.m:28-51): the numerical rank comes
    from the SVD of the replicated R (singular values <= rank_tol *
    sigma_1 are deficient); when rank <= 1 the deficient directions are
    replaced by random ones (a generator seeded from ``key`` and the rank)
    orthogonalized against the survivors.  Returns (Q, R, rank)."""
    m = X_local.shape[1]
    Q, R = local_qr(X_local, qr_method, mp, mesh)
    U, S, _ = np.linalg.svd(R)
    bad = S <= rank_tol * S[0]
    rank = int(m - np.sum(bad))
    if rank > 1:  # a replicated decision: every rank takes this branch
        return Q, R, rank
    gen = torch.Generator(device="cpu").manual_seed(int(key) * 1_000_003 + mesh.rank)
    rnd = torch.randn(X_local.shape, generator=gen, dtype=X_local.dtype).to(X_local.device)
    badt = torch.as_tensor(bad, device=X_local.device)[None, :]
    Qrot = Q @ torch.as_tensor(U, dtype=Q.dtype, device=Q.device)
    Qgood = torch.where(badt, torch.zeros_like(Qrot), Qrot)
    Y = torch.where(badt, rnd, Qrot)
    for _ in range(2):
        G = local_gram(Qgood, Y, mesh=mesh)
        Y = torch.where(badt, Y - Qgood @ torch.as_tensor(G, dtype=Y.dtype, device=Y.device), Y)
    Q2, _ = local_qr(Y, qr_method, mesh=mesh)
    return Q2, R, rank


def local_gram(Q_local: torch.Tensor, X_local: torch.Tensor, mp: bool = False,
               mesh: Mesh = None) -> np.ndarray:
    """Replicated Gram product Q^T X (host f64; accumulated in float64
    when ``mp``, else in the wider of the two dtypes)."""
    if mp and X_local.dtype != torch.float64:
        return _host(psum_rows(_f64(Q_local).T @ _f64(X_local), mesh))
    dt = torch.promote_types(Q_local.dtype, X_local.dtype)
    return _host(psum_rows(Q_local.to(dt).T @ X_local.to(dt), mesh))


def local_project(Q_local: torch.Tensor, X_local: torch.Tensor, passes: int = 2,
                  mp: bool = False, mesh: Mesh = None):
    """Block CGS of X against orthonormal Q, ``passes`` fixed passes.
    Returns (Y_local, R accumulated, host f64).  ``mp``: Gram products and
    corrections in float64, Y in X's dtype."""
    mp = mp and X_local.dtype != torch.float64
    R = np.zeros((Q_local.shape[1], X_local.shape[1]))
    Y = X_local
    for _ in range(passes):
        Rp = local_gram(Q_local, Y, mp, mesh)
        if mp:
            Y = (_f64(Y) - _f64(Q_local) @ torch.as_tensor(Rp, device=Y.device)).to(X_local.dtype)
        else:
            Y = Y - Q_local @ torch.as_tensor(Rp, dtype=Q_local.dtype, device=Y.device)
        R = R + Rp
    return Y, R


def local_norm(x_local: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """Global 2-norm of a row-sharded vector (a host float) or multivector
    (per column, host f64 array)."""
    sq = torch.sum(torch.abs(x_local) ** 2, dim=0)
    out = np.sqrt(_host(psum_rows(sq.reshape(-1), mesh)))
    return float(out[0]) if x_local.ndim == 1 else out
