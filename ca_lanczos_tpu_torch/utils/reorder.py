"""Bandwidth reduction: map general sparse matrices onto the banded path.

Counterpart of ``ca_lanczos_tpu/utils/reorder.py``.  For most
SuiteSparse-style symmetric matrices a reverse Cuthill-McKee reordering
shrinks the bandwidth enough to store the matrix as DIA, which the DIA
kernels (K1/K2) serve, or as bounded-bandwidth ELL.

Eigenvalues are invariant under the symmetric permutation P A P^T;
eigenvectors come back through ``Reordering.restore``.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.formats import dia_from_scipy
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, EllMatrix


@dataclasses.dataclass
class Reordering:
    """Symmetric permutation bundle: ``A_reordered = A[perm][:, perm]``.
    ``apply`` and ``restore`` act on axis 0: numpy in, numpy out; a tensor
    in, a tensor out on its device."""

    A: Union[DiaMatrix, EllMatrix]
    perm: np.ndarray  # new_index -> old_index
    bandwidth_before: int
    bandwidth_after: int

    def restore(self, x):
        """Map vectors/multivectors from reordered back to original row
        order (inverse permutation applied to axis 0)."""
        if isinstance(x, torch.Tensor):
            out = torch.empty_like(x)
            out[torch.as_tensor(self.perm, device=x.device)] = x
            return out
        x = np.asarray(x)
        out = np.empty_like(x)
        out[self.perm] = x
        return out

    def apply(self, x):
        """Map original-order vectors into the reordered space."""
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(self.perm, device=x.device)]
        return np.asarray(x)[self.perm]


def rcm_reorder(
    a,
    dia_max_diags: int = 64,
    symmetric_mode: bool = True,
    device="cuda",
) -> Reordering:
    """Reverse Cuthill-McKee reordering of a scipy matrix / dense array /
    port operator; returns the permuted operator on ``device`` in the
    narrowest format: DIA (float64 planes) when it lives on at most
    ``dia_max_diags`` diagonals, else ELL."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    if isinstance(a, (DiaMatrix, EllMatrix)):
        a = sp.csr_matrix(a.to_dense().cpu().numpy())
    elif not sp.issparse(a):
        a = sp.csr_matrix(np.asarray(a))
    else:
        a = sp.csr_matrix(a)

    coo0 = a.tocoo()
    bw_before = int(np.max(np.abs(coo0.row - coo0.col))) if coo0.nnz else 0

    perm = np.ascontiguousarray(reverse_cuthill_mckee(a, symmetric_mode=symmetric_mode))
    ap = a[perm][:, perm].tocoo()
    bw_after = int(np.max(np.abs(ap.row - ap.col))) if ap.nnz else 0

    A = dia_from_scipy(ap, max_diags=dia_max_diags, waste_cap=float("inf"), dtype=np.float64,
                       device=device)
    if A is None:
        A = EllMatrix.from_scipy(ap, device=device)
    return Reordering(A=A, perm=perm, bandwidth_before=bw_before, bandwidth_after=bw_after)
