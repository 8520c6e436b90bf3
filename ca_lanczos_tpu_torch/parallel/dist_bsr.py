"""Row-sharded BSR operator with halo exchange.

Counterpart of ``ca_lanczos_tpu/parallel/dist_bsr.py``.  BASELINE.json
configs[4] runs s-step CA-Lanczos on a >=10M-row BSR matrix across
hosts; BSR is the format of FEM/multiphysics operators whose sparsity
comes in dense node blocks (``ops.bsr``).  The partition is DistEll's
contiguous windows one granularity up: each rank holds its BLOCK rows
plus the s-hop ghost block rows, block columns rebased to the local
padded window, and the matrix powers pay one halo exchange (``halo_b *
bm`` rows a side) per s local block products.  The local product is the
x-block gather and one ``torch.einsum`` over the tiles, as in
``ops.bsr`` (the JAX package's is an einsum too: no hand kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
from ca_lanczos_tpu_torch.parallel.distributed import (
    RowState,
    _coefs,
    _halo_exchange,
    check_s_bound,
)
from ca_lanczos_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True, eq=False)
class DistBsr(RowState):
    """This rank's block of a row-sharded BSR operator with an s-deep
    BLOCK-row halo.

    vals: (mb, kb, bm, bm) padded block rows, mb = nb_local + 2*halo_b;
    cols: (mb, kb) LOCAL block indices into the padded window (zero tiles
    point at 0).  halo_b = s_max * block bandwidth; ``halo`` is it in rows.
    """

    vals: torch.Tensor
    cols: torch.Tensor
    halo_b: int
    n: int
    mesh: Mesh
    s_max: int = 0
    _casts: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def bm(self) -> int:
        return self.vals.shape[2]

    @property
    def nb_local(self) -> int:
        return self.vals.shape[0] - 2 * self.halo_b

    @property
    def n_local(self) -> int:
        return self.nb_local * self.bm

    @property
    def halo(self) -> int:
        """The halo in rows (what the exchange moves a side)."""
        return self.halo_b * self.bm

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def planes(self, dtype: torch.dtype) -> torch.Tensor:
        """``vals`` in ``dtype`` (kept after the first cast; einsum takes
        one dtype, and wider state multiplies in its own precision)."""
        return self._cast(self.vals, dtype)

    @staticmethod
    def from_bsr(A: BsrMatrix, mesh: Mesh, s_max: int) -> "DistBsr":
        """This rank's window of ``A`` with an s_max-deep block halo, on
        ``mesh.device``.  Block bandwidth is measured over the live
        (nonzero) tiles; block columns of unbounded spread should be
        RCM-reordered at the scalar level first, as for DistEll."""
        P_, p = mesh.size, mesh.rank
        vals = A.vals.detach().cpu().numpy()
        cols = A.cols.detach().cpu().numpy().astype(np.int64)
        nb, kb, bm, bn = vals.shape
        if bm != bn:
            raise ValueError("square blocks only")
        live = vals.reshape(nb, kb, -1).any(axis=2)
        rows_b = np.arange(nb)[:, None]
        bw_b = max(int(np.max(np.where(live, np.abs(cols - rows_b), 0))) if nb else 0, 1)
        nb_local = -(-nb // P_)
        halo_b = s_max * bw_b
        if halo_b >= nb_local:
            raise ValueError(
                f"block halo {halo_b} (s_max={s_max} x block bandwidth {bw_b}) >= block "
                f"rows/shard {nb_local}: reduce bandwidth or lower s")
        mb = nb_local + 2 * halo_b
        base = p * nb_local - halo_b  # global block row of window row 0
        lo, hi = max(base, 0), min(base + mb, nb)
        v = np.zeros((mb, kb, bm, bm), vals.dtype)
        c = np.zeros((mb, kb), np.int64)
        if hi > lo:
            v[lo - base:hi - base] = vals[lo:hi]
            c[lo - base:hi - base] = cols[lo:hi] - base
        valid = v.reshape(mb, kb, -1).any(axis=2) & (c >= 0) & (c < mb)
        v[~valid] = 0
        c[~valid] = 0
        return DistBsr(vals=torch.from_numpy(v).to(mesh.device),
                       cols=torch.from_numpy(c).to(mesh.device), halo_b=halo_b, n=A.n,
                       mesh=mesh, s_max=s_max)

    def matvec_padded(self, xp: torch.Tensor) -> torch.Tensor:
        """The window's block product on a padded vector (mb*bm,)."""
        mb, bm = self.vals.shape[0], self.bm
        xb = xp.reshape(mb, bm)[self.cols]  # (mb, kb, bm)
        return torch.einsum("ikab,ikb->ia", self.planes(xp.dtype), xb).reshape(mb * bm)


def _bsr_powers_local(A: DistBsr, x_local: torch.Tensor, coefs: np.ndarray, s: int,
                      mesh: Mesh, include_q: bool = True) -> torch.Tensor:
    """One halo exchange of ``halo_b*bm`` rows a side + s local block
    steps.  Returns rows: (s+1, n_local) with x first, or (s, n_local)
    with ``include_q=False``."""
    x_local = x_local.contiguous()
    xp = _halo_exchange(x_local, A.halo, mesh, False)
    V = xp.new_empty((s, xp.shape[0]))
    prev, cur = torch.zeros_like(xp), xp
    for k in range(s):
        V[k] = A.matvec_padded(cur) - float(coefs[k, 0]) * cur - float(coefs[k, 1]) * prev
        prev, cur = cur, V[k]
    center = V[:, A.halo:A.halo + x_local.shape[0]]
    if not include_q:
        return center
    return torch.cat([x_local[None, :], center], dim=0)


def dist_bsr_matrix_powers(A: DistBsr, x: torch.Tensor, s: int, diag, sub,
                           mesh: Mesh) -> torch.Tensor:
    """This rank's (n_local, s+1) block of [x, p_1(A)x, ..., p_s(A)x] on
    block sparsity.  A transposed view of contiguous rows."""
    check_s_bound(A, s)
    return _bsr_powers_local(A, x, _coefs(diag, sub, s), s, mesh).T
