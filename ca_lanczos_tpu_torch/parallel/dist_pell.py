"""Row-sharded PELL operator: distributed general sparsity through K4.

Counterpart of ``ca_lanczos_tpu/parallel/dist_pell.py``.  ``DistPell``
keeps DistEll's partition (contiguous row blocks, an s-hop matrix halo,
one exchange per s steps: ``dist_ell.ell_shard_planes``) and encodes the
rank's (m x m) padded-window operator, m = n_local + 2*halo, as a
unit-encoded ``PellMatrix``, so the local steps run the PELL kernel K4
(``ops.cuda_pell.pell_step``, ``csrc/pell.cu``) instead of a gather.  The
window's last halo rows on each side are ghost rows with truncated
stencils: step k pollutes only the outer k*bw rows, so the centre stays
exact while s <= s_max (``check_s_bound``).

The JAX package pads every shard's planes to common statics because it
stacks them into one array; a rank here holds its own window alone, so
it encodes it alone (the padded slots were zero-valued no-ops).

Kernel seam, as in the JAX package: the state is cast to the planes'
dtype before K4 and the powers return in the state's dtype (an f64 IRL
state on f32 planes runs K4 in f32), unlike DistDia's natural engine,
which multiplies in the state's precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.pell import PellMatrix
from ca_lanczos_tpu_torch.ops.spmv import EllMatrix
from ca_lanczos_tpu_torch.parallel.dist_ell import ell_shard_planes
from ca_lanczos_tpu_torch.parallel.distributed import (
    RowState,
    _coefs,
    _halo_exchange,
    check_s_bound,
)
from ca_lanczos_tpu_torch.parallel.mesh import Mesh


def window_csr(vals: np.ndarray, cols: np.ndarray):
    """The (m x m) scipy CSR of one shard's window planes (m, k): each
    row's nonzero slots in slot order."""
    import scipy.sparse as sp

    m = vals.shape[0]
    mask = vals != 0
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    return sp.csr_matrix((vals[mask], cols[mask], indptr), shape=(m, m))


@dataclasses.dataclass(frozen=True, eq=False)
class DistPell(RowState):
    """This rank's block of a row-sharded PELL operator.

    A: the unit-encoded (m x m) window operator on the rank's device,
    m = n_local + 2*halo (global rows [p*n_local - halo, (p+1)*n_local +
    halo)).  ``s_max`` is the partition-time bound on s.
    """

    A: PellMatrix
    halo: int
    n: int
    mesh: Mesh
    periodic: bool = False
    s_max: int = 0

    @property
    def m(self) -> int:
        """Window rows."""
        return self.A.n

    @property
    def n_local(self) -> int:
        return self.m - 2 * self.halo

    @property
    def n_x(self) -> int:
        """Kernel vector length of the window operator."""
        return self.A.n_x

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    @property
    def device(self) -> torch.device:
        return self.A.device

    @staticmethod
    def from_ell(A: EllMatrix, mesh: Mesh, s_max: int, periodic: bool = False,
                 tile: int = 1024, max_windows: int = 16) -> "DistPell":
        """Partition ``A`` (``ell_shard_planes``: bandwidth, halo, rebase,
        periodic ring windows) and encode this rank's window, unit
        encoding (K4), on ``mesh.device``."""
        sv, sc, halo, n = ell_shard_planes(A, mesh.size, s_max, periodic, ranks=[mesh.rank])
        csr = window_csr(sv[0], sc[0])
        del sv, sc
        Ap = PellMatrix.from_scipy(csr, tile=tile, max_windows=max_windows,
                                   device=mesh.device, encoding="unit")
        return DistPell(A=Ap, halo=halo, n=n, mesh=mesh, periodic=periodic, s_max=s_max)


def _pell_powers_local(A: DistPell, x_local: torch.Tensor, coefs: np.ndarray, s: int,
                       mesh: Mesh, include_q: bool = True) -> torch.Tensor:
    """One halo exchange + s K4 steps on the window: the padded vector
    (cast to the planes' dtype) is row 0 of one (s+1, n_x) buffer and
    step k writes row k+1 (``out=``), as ``ops.pell.matrix_powers_pell``
    does.  Returns rows in x's dtype: (s+1, n_local) with x first, or
    (s, n_local) with ``include_q=False``."""
    from ca_lanczos_tpu_torch.ops.cuda_pell import pell_step

    W = A.A
    m, n_x, n_pad, h = A.m, W.n_x, W.n_pad, A.halo
    x_local = x_local.contiguous()
    xp = _halo_exchange(x_local.to(W.dtype), h, mesh, A.periodic)
    V = xp.new_empty((s + 1, n_x))
    V[0, :m] = xp
    V[0, m:] = 0
    V[1:, n_pad:] = 0  # the steps write rows [0, n_pad)
    for k in range(s):
        pell_step(W, V[k], V[k - 1] if k else None, float(coefs[k, 0]), float(coefs[k, 1]),
                  out=V[k + 1])
    center = V[1:, h:h + x_local.shape[0]].to(x_local.dtype)
    if not include_q:
        return center
    return torch.cat([x_local[None, :], center], dim=0)


def dist_pell_matrix_powers(A: DistPell, x: torch.Tensor, s: int, diag, sub,
                            mesh: Mesh) -> torch.Tensor:
    """This rank's (n_local, s+1) block of [x, p_1(A)x, ..., p_s(A)x]
    through K4 on the rank's window, in x's dtype.  A transposed view of
    contiguous rows."""
    check_s_bound(A, s)
    return _pell_powers_local(A, x, _coefs(diag, sub, s), s, mesh).T
