"""Distributed implicitly-restarted CA-Lanczos.

Counterpart of ``ca_lanczos_tpu/parallel/dist_irl.py``: the IRL driver
(``solvers.implicitly_restarted``, impl_restarted_ca_lanczos.m) with the
n-sized state row-sharded:

* the Krylov extension from k to m columns runs distributed CA blocks
  (``parallel.step.dist_ca_block``) with a full-history cleanup per block;
* the exact-shift QR bulge chase (``solvers.implicitly_restarted.qrstep``)
  is host math on the m x m T, repeated identically on every rank;
* the compression V <- V Q[:, :k] and the residual update are local GEMMs
  of each rank's rows by replicated small matrices: no collective.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.config import Basis
from ca_lanczos_tpu_torch.ops.spmv import normest
from ca_lanczos_tpu_torch.parallel.dist_orth import local_norm
from ca_lanczos_tpu_torch.parallel.mesh import Mesh
from ca_lanczos_tpu_torch.parallel.restarted import _bootstrap, _dist_reorth, _dist_spmv_any
from ca_lanczos_tpu_torch.parallel.step import (
    dist_ca_block,
    dist_first_block,
    newton_coeffs,
    partition_operator,
)
from ca_lanczos_tpu_torch.solvers._block import block_T, first_block_T
from ca_lanczos_tpu_torch.solvers.implicitly_restarted import IRLResult, qrstep


def _small(M: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(M), dtype=like.dtype, device=like.device)


def _verify_ritz(Adist, Vr: torch.Tensor, Y: np.ndarray, d: np.ndarray, order, k: int,
                 mesh: Mesh, tol: float, slack: float = 10.0) -> bool:
    """True residuals ||A x - theta x|| / ||x|| of the wanted Ritz pairs
    against ``slack * tol`` (tol already ||A||-scaled).  ``Vr`` holds the
    basis as rows; state is ghost-zero, so norms match natural order."""
    for i in order:
        x = _small(Y[:, i], Vr) @ Vr[:k]
        nx = local_norm(x, mesh)
        if nx == 0.0:
            return False
        true_abs = local_norm(_dist_spmv_any(Adist, x, mesh) - float(d[i]) * x, mesh) / nx
        if true_abs > slack * tol:
            return False
    return True


def dist_impl_restarted_ca_lanczos(
    A,
    r,
    max_lanczos: int,
    mesh: Mesh,
    n_wanted: int = 10,
    s: int = 4,
    basis: Basis = Basis.NEWTON,
    tol: float = 1.0e-6,
    max_restarts: int = 40,
    qr_method: str = "tsqr",
    dist_format: str = "auto",
    mixed_precision: bool = False,
) -> IRLResult:
    """Distributed IRL with a CA inner iteration and a full-history
    cleanup per block (the compressed columns are dense mixtures, so the
    trailing block alone is not enough; the single-card driver's
    orth=FULL).  ``A`` is partitioned by ``step.partition_operator``
    (DiaMatrix, EllMatrix, BsrMatrix); ``dist_format="ilv"`` runs banded
    f32 operators on the interleaved engine, state in that domain end to
    end, and ``"pell"`` an EllMatrix through K4.  The state dtype
    follows the start vector when it is wider than the operator (repeated
    compressions need f64 to keep the basis orthonormal); the kernels run
    in the planes' dtype.  Every rank returns the same result, Q_conv
    gathered (n, n_wanted)."""
    from ca_lanczos_tpu_torch.parallel.driver import _as_host, root_eval

    basis = Basis(basis)
    norm_A = root_eval(mesh, A, normest)
    tol = tol * norm_A

    k = n_wanted + 4
    k = s * (-(-k // s))  # CA blocks must tile the window
    p = s * ((max_lanczos - k) // s)
    m = k + p
    if p <= 0:
        raise ValueError(f"max_lanczos={max_lanczos} too small for k={k} + s={s}")

    r_host = _as_host(r)
    r_np = r_host.astype(np.float64)
    q_host = r_np / np.linalg.norm(r_np)
    Bk = _bootstrap(A, q_host, s, basis, mesh)
    diag, sub = newton_coeffs(Bk)

    Adist = partition_operator(A, mesh, s_max=s, dist_format=dist_format)
    q = Adist.shard_entry(q_host)
    want = torch.as_tensor(np.zeros(0, r_host.dtype)).dtype
    if want.is_floating_point and want.itemsize > q.dtype.itemsize:
        q = q.to(want)
    dtype = q.dtype
    N = Adist.state_len

    def extend(Vr: Optional[torch.Tensor], T: np.ndarray, k0: int):
        """Extend the factorization to m+1 basis rows by CA blocks; row k0
        of ``Vr`` is the current residual direction."""
        b_prev = T[k0, k0 - 1] if k0 > 0 else 0.0
        nvecs = k0
        if nvecs == 0:
            Qb, Rk = dist_first_block(Adist, q, diag, sub, s, mesh, qr_method,
                                      mp=mixed_precision)
            Vr = torch.zeros((m + 1, N), dtype=dtype, device=q.device)
            Vr[: s + 1] = Qb.T
            Tk, b_new = first_block_T(Rk, Bk, s)
            T[: s + 1, :s] = Tk
            b_prev = b_new
            nvecs = s
        while nvecs <= m - s:
            Q_prev = Vr[nvecs - s: nvecs + 1].T
            Q_new, Rkk, R = dist_ca_block(Adist, Q_prev, diag, sub, s, mesh, qr_method,
                                          mp=mixed_precision)
            # Full-history cleanup against every row of Vr (future rows are
            # zero, so one shape serves every block).
            Q_new = _dist_reorth(Adist, Vr.T, Q_new, mesh, qr_method, mp=mixed_precision)
            Vr[nvecs + 1: nvecs + s + 1] = Q_new.T
            Tk, b_new, _ = block_T(Rkk, R, Bk, b_prev, s)
            T[nvecs: nvecs + s, nvecs: nvecs + s] = Tk
            T[nvecs, nvecs - 1] = b_prev
            T[nvecs - 1, nvecs] = b_prev
            T[nvecs + s, nvecs + s - 1] = b_new
            if nvecs + s < T.shape[1]:
                T[nvecs + s - 1, nvecs + s] = 0.0
            b_prev = b_new
            nvecs += s
        return Vr, T, float(T[m, m - 1])

    Vr: Optional[torch.Tensor] = None
    T = np.zeros((m + 1, m))
    n_restarts = 0
    converged = False
    while n_restarts < max_restarts:
        n_restarts += 1
        k0 = 0 if n_restarts == 1 else k
        Vr, T, beta_m = extend(Vr, T, k0)

        Tm = T[:m, :m].copy()
        theta = np.linalg.eigvalsh((Tm + Tm.T) / 2)
        shifts = theta[:p]

        Qh = np.eye(m)
        H = Tm
        for mu in shifts:
            Qh, H = qrstep(Qh, H, mu, 0, m)

        # Compression V_k = V Q[:, :k] and the residual update, rows local.
        Vk_new = _small(Qh[:, :k].T, Vr) @ Vr[:m]
        r_new = (_small(Qh[:, k] * H[k, k - 1], Vr) @ Vr[:m]
                 + (beta_m * float(Qh[m - 1, k - 1])) * Vr[m])
        beta_k = local_norm(r_new, mesh)

        T = np.zeros((m + 1, m))
        T[:k, :k] = H[:k, :k]
        T[k, k - 1] = beta_k
        T[k - 1, k] = beta_k
        Vr = torch.zeros((m + 1, N), dtype=dtype, device=q.device)
        Vr[:k] = Vk_new
        Vr[k] = r_new / beta_k

        Tk_sym = (T[:k, :k] + T[:k, :k].T) / 2
        d, Y = np.linalg.eigh(Tk_sym)
        rnorms = beta_k * np.abs(Y[k - 1, :])
        order = np.argsort(d)[::-1][:n_wanted]
        if int(np.sum(rnorms[order] < tol)) >= n_wanted:
            # The estimate trusts the compressed basis' orthogonality:
            # check the true residuals before declaring convergence.
            if _verify_ritz(Adist, Vr, Y, d, order, k, mesh, tol):
                converged = True
                break

    Tk_sym = (T[:k, :k] + T[:k, :k].T) / 2
    d, Y = np.linalg.eigh(Tk_sym)
    order = np.argsort(d)[::-1][:n_wanted]
    eigs = d[order]
    rnorms = (float(T[k, k - 1]) * np.abs(Y[k - 1, :]))[order]
    X = (_small(Y[:, order].T, Vr) @ Vr[:k]).T
    Q_conv = torch.from_numpy(Adist.gather_columns(X))
    return IRLResult(eigs=eigs, Q_conv=Q_conv, n_restarts=n_restarts,
                     conv_rnorms=rnorms, converged=converged)
