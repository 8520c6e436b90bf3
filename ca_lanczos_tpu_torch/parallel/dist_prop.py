"""Distributed Lanczos time propagation on the split representation.

Counterpart of ``ca_lanczos_tpu/parallel/dist_prop.py``.  The
reference's propagation experiment (runLanczos.m:66-131) uses a periodic
Hamiltonian (wrap entries, :15-18); the ring-periodic halo
(``distributed._halo_exchange(periodic=True)``) carries the wrap, so the
complex wave function, as a real (n, 2) re/im multivector (the split
path of ``solvers.propagators``), propagates row-sharded:

* the product: one halo exchange of the rank's (n_local, 2) rows, then
  the local product of each column: K2 on the padded DIA shard (as the
  single-card split propagators send each row to K1/K2; the JAX
  package's banded product here is plain XLA), or the ELL gather;
* alpha and beta: all-reduced sums (``dist_orth.psum_rows``), read by
  the host together, once a Krylov step;
* the small exponential of T stays host math (lanczos_prop.m:44-50).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ca_lanczos_tpu_torch.parallel.dist_ell import DistEll
from ca_lanczos_tpu_torch.parallel.dist_orth import psum_rows
from ca_lanczos_tpu_torch.parallel.distributed import DistDia, _halo_exchange
from ca_lanczos_tpu_torch.parallel.mesh import Mesh
from ca_lanczos_tpu_torch.solvers.propagators import _expm_tridiag, _tridiag


def _gsum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global sum of a row-sharded tensor's entries, (1,) on the
    device (one all-reduce)."""
    return psum_rows(t.sum().reshape(1), mesh)


def dist_spmv_cols(A: Union[DistDia, DistEll], x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A x for this rank's rows x (n_local, c) of a row-sharded
    multivector: one halo exchange, then the local product of each column
    (K2 on the padded DIA shard on the card, the ELL gather)."""
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, spmv

    n_local = x.shape[0]
    xp = _halo_exchange(x.contiguous(), A.halo, mesh, A.periodic)
    if isinstance(A, DistDia):
        W = DiaMatrix(data=A.planes(xp.dtype), offsets=A.offsets)
        y = torch.stack([spmv(W, xp[:, j].contiguous()) for j in range(xp.shape[1])], dim=1)
    elif isinstance(A, DistEll):
        y = A.matvec_padded(xp)
    else:
        raise TypeError(f"dist_spmv_cols takes a DistDia or DistEll, not {type(A).__name__}")
    return y[A.halo:A.halo + n_local]


def dist_lanczos_prop_split(A, psi: torch.Tensor, maxiter: int, dt: float, mesh: Mesh,
                            tol: float = 1.0e-10, adaptive: bool = False):
    """One Krylov propagation solve (lanczos_prop.m:15-61 on the split
    representation).  psi: this rank's rows (n_local, 2), unnormalized.
    Returns (T (j, j), Q (n_local, 2, j+1) this rank's rows, nrm, j)."""
    nrm = float(torch.sqrt(_gsum(psi * psi, mesh)))
    cols = [psi / nrm]
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)
    j_used = maxiter
    for j in range(1, maxiter + 1):
        qj = cols[j - 1]
        w = dist_spmv_cols(A, qj, mesh)
        if j > 1:
            w = w - beta[j - 2] * cols[j - 2]
        a = _gsum(qj * w, mesh)
        w = w - a * qj
        b = torch.sqrt(_gsum(w * w, mesh))
        cols.append(w / b)
        alpha[j - 1], beta[j - 1] = torch.cat([a, b]).cpu().tolist()  # one host read
        if adaptive and j >= 3:
            E = _expm_tridiag(_tridiag(alpha[:j], beta[:j]), dt)
            if abs(dt * beta[j - 1] * E[j - 1, 0]) * nrm < tol:
                j_used = j
                break
        j_used = j
    T = _tridiag(alpha[:j_used], beta[:j_used])
    return T, torch.stack(cols[: j_used + 1], dim=2), nrm, j_used


def dist_propagate_split(A, psi0, dt: float, n_steps: int, mesh: Mesh, krylov_dim: int = 24,
                         tol: float = 1.0e-10, adaptive: bool = False) -> np.ndarray:
    """The distributed runLanczos time loop: psi0 a host complex (n,)
    vector; returns the final complex psi (n,) on the host, on every rank.
    ``A`` is a DistDia or DistEll (built with ``periodic=True`` for the
    reference's wrap Hamiltonian, runLanczos.m:15-18)."""
    psi0 = np.asarray(psi0)
    psi = A.shard_vector(np.stack([np.real(psi0), np.imag(psi0)], axis=1))
    for _ in range(n_steps):
        T, Q, nrm, j = dist_lanczos_prop_split(A, psi, krylov_dim, dt, mesh, tol, adaptive)
        w = _expm_tridiag(T, dt)[:, 0] * nrm  # complex weights on the Krylov basis
        wr = torch.as_tensor(np.real(w), dtype=Q.dtype, device=Q.device)
        wi = torch.as_tensor(np.imag(w), dtype=Q.dtype, device=Q.device)
        Qb = Q[:, :, :j]
        psi = torch.stack([Qb[:, 0, :] @ wr - Qb[:, 1, :] @ wi,
                           Qb[:, 0, :] @ wi + Qb[:, 1, :] @ wr], dim=1)
    host = A.gather_columns(psi)
    return host[:, 0] + 1j * host[:, 1]
