"""Full-orthogonalization Arnoldi extension (reference: arnoldi.m:3-44).

Counterpart of ``ca_lanczos_tpu/solvers/arnoldi.py``.  Extends an existing
factorization A Q_k = Q_{k+1} H by CGS-orthogonalizing each new A q_j
against ALL previous basis vectors; the alternative inner iteration of the
implicitly-restarted driver (``inner="arnoldi"``; commented call sites at
impl_restarted_ca_lanczos.m:89,94).  The projection h = Q^H (A q) and the
update are GEMVs on the operator's device; H bookkeeping is host math.

The basis is kept as (maxvecs+1, n) rows; step j reads only its first
j+1 rows, where the JAX package masks the columns past j of the whole
basis (the same function).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.spmv import Operator, spmv


def _arnoldi_step(A: Operator, Q: torch.Tensor, j: int, reorth: bool = False):
    """w = A q_j; h = Q[:j+1]^H w; w -= Q h; g = ||w|| (Q as rows).

    reorth=True adds a second CGS pass (h accumulates) — required when
    the basis spans nearly-converged directions (the IRL resume), where
    one classical pass loses orthogonality catastrophically."""
    w = spmv(A, Q[j])
    Qm = Q[: j + 1]
    h = Qm.conj() @ w
    w = w - Qm.T @ h
    if reorth:
        h2 = Qm.conj() @ w
        w = w - Qm.T @ h2
        h = h + h2
    g = torch.linalg.norm(w)
    return w / g, h, g


def arnoldi(
    A: Operator,
    q: torch.Tensor,
    maxvecs: int,
    Q: Optional[torch.Tensor] = None,
    H: Optional[np.ndarray] = None,
    prevvecs: int = 0,
    reorth: bool = False,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Extend (Q, H) to ``maxvecs`` Arnoldi vectors (arnoldi.m:3-44).

    With prevvecs == 0 a fresh factorization is started from q; otherwise
    Q (n, >= prevvecs+1) and H hold the factorization to extend.
    ``reorth`` selects two-pass CGS per step (see _arnoldi_step).
    Returns (Q (n, maxvecs+1), H ((maxvecs+1), maxvecs)) with
    A Q[:, :maxvecs] = Q H; Q is the transposed view of its row storage.
    """
    n = q.shape[0]
    Qf = torch.zeros((maxvecs + 1, n), dtype=q.dtype, device=q.device)
    h_dtype = np.complex128 if q.is_complex() else np.float64
    Hf = np.zeros((maxvecs + 1, maxvecs), h_dtype)
    if prevvecs > 0:
        if Q is None or H is None:
            raise ValueError("extending a factorization (prevvecs > 0) needs Q and H")
        Qf[: prevvecs + 1] = Q[:, : prevvecs + 1].T
        Hf[: H.shape[0], : H.shape[1]] = H
    else:
        Qf[0] = q / torch.linalg.norm(q)

    for j in range(prevvecs, maxvecs):
        qn, h, g = _arnoldi_step(A, Qf, j, reorth=reorth)
        Qf[j + 1] = qn
        Hf[: j + 1, j] = h.cpu().numpy().astype(h_dtype)
        Hf[j + 1, j] = float(g)
    return Qf.T, Hf
