"""Distributed CA-Lanczos driver: host control over per-rank block steps.

Counterpart of ``ca_lanczos_tpu/parallel/driver.py``.  The Krylov blocks
live row-sharded (each rank its rows); each outer iteration runs one
block step (``parallel.step``) and the O(s^2) tridiagonal recovery runs
on every rank's host from the replicated R factors — one halo exchange,
one all-gather and two all-reduced Gram products per block.

Computations on the whole host operator (``normest``, the Newton
bootstrap) run on rank 0's device and are broadcast (:func:`root_eval`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.config import Basis
from ca_lanczos_tpu_torch.parallel import comm
from ca_lanczos_tpu_torch.parallel.dist_orth import local_norm, psum_rows
from ca_lanczos_tpu_torch.parallel.distributed import DistDia, dist_spmv
from ca_lanczos_tpu_torch.parallel.mesh import Mesh
from ca_lanczos_tpu_torch.parallel.step import dist_ca_block, dist_first_block, newton_coeffs
from ca_lanczos_tpu_torch.solvers._block import block_T, extend_T, first_block_T
from ca_lanczos_tpu_torch.solvers.ca_lanczos import monomial_basis_matrix


def root_eval(mesh: Mesh, A, fn):
    """``fn(A on rank 0's device)`` computed on rank 0 and broadcast."""
    return comm.on_root(lambda: fn(A.to(mesh.device)), mesh.device)


def _as_host(r) -> np.ndarray:
    return r.detach().cpu().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)


@dataclasses.dataclass
class DistCaLanczosResult:
    T: np.ndarray  # (s*t, s*t)
    Q_blocks: List[torch.Tensor]  # this rank's rows of each basis block
    beta: np.ndarray
    n: int  # true (unpadded) dimension
    op: Optional[object] = None  # the partitioned operator (decodes .Q)

    @property
    def Q(self) -> np.ndarray:
        """Gathered dense basis (host, natural order), s*t columns; a
        collective (every rank must read it).  Blocks overlap by one column
        (each block's first is the previous block's last)."""
        cols = [self.Q_blocks[0]] + [B[:, 1:] for B in self.Q_blocks[1:]]
        Qfull = self.op.gather_columns(torch.cat(cols, dim=1))
        return Qfull[:, : self.T.shape[0]]


def dist_ca_lanczos(
    A,
    r,
    s: int,
    total_steps: int,
    mesh: Mesh,
    basis: Basis = Basis.MONOMIAL,
    Bk: Optional[np.ndarray] = None,
    qr_method: str = "tsqr",
    orth=None,
    dist_format: str = "auto",
    mixed_precision: bool = False,
) -> DistCaLanczosResult:
    """Row-sharded CA-Lanczos with all four orth modes (ca_lanczos.m:27-39).

    Semantics mirror ``solvers.ca_lanczos`` except that the block CGS
    always runs two passes.  FULL re-orthogonalizes every new block
    against the zero-padded history; PERIODIC does so when the host omega
    recurrence says (ca_lanczos.m:430-446); SELECTIVE tracks converged
    Ritz vectors in a fixed-width padded basis (ca_lanczos.m:317-336).
    ``A`` is a DiaMatrix, EllMatrix or BsrMatrix (every rank passes the
    same; ``step.partition_operator`` distributes it) or a distributed
    operator; the Newton basis needs an explicit ``Bk``.
    ``dist_format="ilv"`` runs the interleaved engine (f32 banded): the
    state lives in the ghost-zeroed padded interleaved domain, where
    Gram/CGS/QR are layout-invariant; ``"pell"`` runs an EllMatrix through
    K4 on each rank's window (DistPell)."""
    from ca_lanczos_tpu_torch.config import Orth
    from ca_lanczos_tpu_torch.ops.spmv import normest
    from ca_lanczos_tpu_torch.parallel.restarted import (
        _dist_ca_block_locked,
        _dist_reorth,
        _dist_ritz_vector,
    )
    from ca_lanczos_tpu_torch.parallel.step import partition_operator
    from ca_lanczos_tpu_torch.utils.diagnostics import OmegaRecurrence

    basis = Basis(basis)
    orth = Orth(orth) if orth is not None else Orth.LOCAL
    t = int(np.ceil(total_steps / s))
    m = s * t
    if Bk is None:
        if basis != Basis.MONOMIAL:
            raise ValueError("newton basis requires an explicit Bk (bootstrap on host)")
        Bk = monomial_basis_matrix(s)
    diag, sub = newton_coeffs(Bk)

    Adist = partition_operator(A, mesh, s_max=s, dist_format=dist_format)
    r = _as_host(r).astype(np.float64)
    q = Adist.shard_entry(r / np.linalg.norm(r))
    dtype = q.dtype

    _EPS = float(np.finfo(np.float64).eps)
    norm_A = (root_eval(mesh, A, normest)
              if orth in (Orth.PERIODIC, Orth.SELECTIVE) else None)
    omega = OmegaRecurrence(norm_A) if orth == Orth.PERIODIC else None
    # Histories in the state domain and the state's dtype (columns
    # re-enter the powers).
    hist_dtype = dtype
    Qhist = (Adist.state_zeros(m + 1, dtype=hist_dtype)
             if orth in (Orth.FULL, Orth.PERIODIC, Orth.SELECTIVE) else None)
    r_cap = min(m, 24)
    QRpad = Adist.state_zeros(r_cap, dtype=hist_dtype) if orth == Orth.SELECTIVE else None
    nritz = 0

    Q_blocks: List[torch.Tensor] = []
    b = np.zeros(t)

    Qb, Rk = dist_first_block(Adist, q, diag, sub, s, mesh, qr_method, mp=mixed_precision)
    Q_blocks.append(Qb)
    T, b[0] = first_block_T(Rk, Bk, s)
    if Qhist is not None:
        Qhist[:, : s + 1] = Qb

    for k in range(2, t + 1):
        if orth == Orth.SELECTIVE:
            Q_new, Rkk, R = _dist_ca_block_locked(
                Adist, Q_blocks[-1], QRpad, diag, sub, s, mesh, qr_method,
                mp=mixed_precision)
        else:
            Q_new, Rkk, R = dist_ca_block(Adist, Q_blocks[-1], diag, sub, s, mesh,
                                          qr_method, mp=mixed_precision)
        Tk, b[k - 1], _ = block_T(Rkk, R, Bk, b[k - 2], s)
        T = extend_T(T, Tk, b[k - 2], b[k - 1], s)

        if orth == Orth.FULL:
            Q_new = _dist_reorth(Adist, Qhist, Q_new, mesh, qr_method, mp=mixed_precision)
        elif orth == Orth.PERIODIC:
            alpha_d = np.diagonal(T[: s * k, : s * k]).copy()
            beta_d = np.diagonal(T[: s * k + 1, : s * k], -1).copy()
            omega.update(alpha_d, beta_d)
            if omega.max_error_block(s) >= np.sqrt(_EPS):
                Q_new = _dist_reorth(Adist, Qhist, Q_new, mesh, qr_method, mp=mixed_precision)
                omega.reset_block(s)

        if Qhist is not None:
            lo = (k - 1) * s + 1
            Qhist[:, lo: lo + s] = Q_new
        Q_blocks.append(torch.cat([Q_blocks[-1][:, -1:], Q_new], dim=1))

        if orth == Orth.SELECTIVE:
            sk = s * k
            d_k, Vp_k = np.linalg.eigh(T[:sk, :sk])
            conv = [i for i in range(sk)
                    if b[k - 1] * abs(Vp_k[sk - 1, i]) < norm_A * np.sqrt(_EPS)][:r_cap]
            if len(conv) > nritz:
                nritz = len(conv)
                for j, i in enumerate(conv):
                    w = np.zeros(m + 1)
                    w[:sk] = Vp_k[:, i]
                    QRpad[:, j] = _dist_ritz_vector(Qhist, w)

    return DistCaLanczosResult(T=T[: s * t, : s * t], Q_blocks=Q_blocks, beta=b, n=A.n,
                               op=Adist)


def dist_lanczos(A, r, maxiter: int, mesh: Mesh):
    """Distributed standard Lanczos (the baseline the CA drivers amortize:
    one halo exchange and two all-reduced dots PER STEP instead of one
    exchange per s steps, lanczos.m:85-134).  Local orthogonalization.
    Returns (T (maxiter, maxiter) host, this rank's rows of Q
    (n_local, maxiter))."""
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

    if not isinstance(A, DiaMatrix):
        raise TypeError("dist_lanczos takes a DiaMatrix")
    Adist = DistDia.from_dia(A, mesh, s_max=1)
    r_np = _as_host(r).astype(np.float64)
    q = Adist.shard_vector(r_np / np.linalg.norm(r_np))
    dtype = q.dtype
    Q = torch.zeros((maxiter + 1, Adist.n_local), dtype=dtype, device=q.device)
    Q[0] = q
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)
    for j in range(1, maxiter + 1):
        w = dist_spmv(Adist, Q[j - 1], mesh)
        if j > 1:
            w = w - beta[j - 2] * Q[j - 2]
        a = float(psum_rows(torch.dot(Q[j - 1], w).reshape(1), mesh).item())
        w = w - a * Q[j - 1]
        bj = local_norm(w, mesh)
        alpha[j - 1], beta[j - 1] = a, bj
        Q[j] = w / bj
    T = np.diag(alpha)
    if maxiter > 1:
        T += np.diag(beta[: maxiter - 1], 1) + np.diag(beta[: maxiter - 1], -1)
    return T, Q[:maxiter].T
