"""BSR (block sparse row) operator: dense (bm, bn) tiles.

Counterpart of ``ca_lanczos_tpu/ops/bsr.py``.  BASELINE.json configs[4]
runs s-step CA-Lanczos on a >=10M-row BSR matrix; BSR is the format of
FEM/multiphysics operators whose sparsity comes in dense node blocks.

Layout (as in the JAX package): ``vals[i, j]`` is the dense (bm, bn) tile
of block-row i at block-column ``cols[i, j]``; padding tiles are all-zero
with an in-range block column.

``matvec`` is plain PyTorch, as the JAX package's is XLA (no Pallas): a
gather of the x blocks and one ``torch.einsum`` over each block row's kb
tiles (a ``torch.bmm`` of one column per tile splits into many small
cuBLAS gemv launches).
``to_dia`` turns a block-banded matrix into a scalar ``DiaMatrix`` whose
powers run the DIA kernels K1/K2.
``make_operator`` never routes to BSR (as in the JAX package): a caller
builds it with ``from_scipy`` / ``from_dense``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    vals: torch.Tensor  # (nb, kb, bm, bn)
    cols: torch.Tensor  # (nb, kb) int64 block-column indices

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (self.vals.shape[2], self.vals.shape[3])

    @property
    def n(self) -> int:
        return self.vals.shape[0] * self.vals.shape[2]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)  # square operators only

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        nb, kb, bm, bn = self.vals.shape
        return nb * kb * bm * bn

    def exact_nnz(self) -> int:
        return int(torch.count_nonzero(self.vals))

    def to(self, device) -> "BsrMatrix":
        return BsrMatrix(vals=self.vals.to(device), cols=self.cols.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for a vector (n,) or a multivector (n, m)."""
        nb, kb, bm, bn = self.vals.shape
        xb = x.reshape(-1, bn, *x.shape[1:])[self.cols]  # (nb, kb, bn[, m])
        y = torch.einsum("ikab,ikb...->ia...", self.vals, xb)
        return y.reshape(nb * bm, *x.shape[1:])

    def to_dense(self) -> torch.Tensor:
        nb, kb, bm, bn = self.vals.shape
        dev = self.device
        rr = (torch.arange(nb, device=dev)[:, None, None, None] * bm
              + torch.arange(bm, device=dev)[None, None, :, None]).expand(nb, kb, bm, bn)
        cc = (self.cols[:, :, None, None] * bn
              + torch.arange(bn, device=dev)[None, None, None, :]).expand(nb, kb, bm, bn)
        out = torch.zeros((nb * bm, nb * bn), dtype=self.dtype, device=dev)
        out.index_put_((rr, cc), self.vals, accumulate=True)
        return out

    @staticmethod
    def from_scipy(a, block_size: int = 8, device="cuda") -> "BsrMatrix":
        """Convert any scipy.sparse matrix; rows/cols padded to a multiple
        of block_size (vectorised, O(nnz))."""
        import scipy.sparse as sp

        n = a.shape[0]
        npad = -(-n // block_size) * block_size
        if npad != n:
            a = sp.bmat([[a, None], [None, sp.eye(npad - n) * 0.0]], format="csr")
        bsr = sp.bsr_matrix(a, blocksize=(block_size, block_size))
        bsr.sort_indices()
        nb = bsr.shape[0] // block_size
        counts = np.diff(bsr.indptr)
        kb = max(1, int(counts.max()))
        rows = np.repeat(np.arange(nb), counts)
        slot = np.arange(bsr.indices.shape[0]) - np.repeat(bsr.indptr[:-1], counts)
        vals = np.zeros((nb, kb, block_size, block_size), bsr.dtype)
        cols = np.zeros((nb, kb), np.int64)
        vals[rows, slot] = bsr.data
        cols[rows, slot] = bsr.indices
        return BsrMatrix(vals=torch.as_tensor(vals, device=device),
                         cols=torch.as_tensor(cols, device=device))

    @staticmethod
    def from_dense(a, block_size: int = 8, device="cuda") -> "BsrMatrix":
        import scipy.sparse as sp

        return BsrMatrix.from_scipy(sp.csr_matrix(np.asarray(a)), block_size, device)

    def to_dia(self, max_offsets: int = 64):
        """Scalar-DIA view of a block-BANDED operator, built where ``vals``
        lives.  Each block entry A[bm*i+b, bm*j+c] lands on scalar offset
        bm*(j-i) + (c-b); contributions to one offset are summed (``+=``,
        as in the JAX package).  Raises when the structural block offsets
        would need more than ``max_offsets`` scalar diagonals (unstructured
        block sparsity: keep BSR)."""
        from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

        nb, kb, bm, bn = self.vals.shape
        if bm != bn:
            raise ValueError("square blocks only")
        dev = self.device
        d_all = self.cols - torch.arange(nb, device=dev)[:, None]  # (nb, kb) block offsets
        live = self.vals.reshape(nb, kb, -1).ne(0).any(-1)
        ds = torch.unique(d_all[live]).tolist() if bool(live.any()) else [0]
        offs = sorted({bm * int(d) + c - b for d in ds for b in range(bm) for c in range(bn)})
        if len(offs) > max_offsets:
            raise ValueError(
                f"block structure needs {len(offs)} scalar diagonals "
                f"(> max_offsets={max_offsets}); not band-convertible"
            )
        lo = offs[0]
        lut = torch.full((offs[-1] - lo + 1,), -1, dtype=torch.int64, device=dev)
        lut[torch.as_tensor(offs, device=dev) - lo] = torch.arange(len(offs), device=dev)
        data = torch.zeros((len(offs), nb * bm), dtype=self.dtype, device=dev)
        for k in range(kb):
            bi = torch.nonzero(live[:, k])[:, 0]
            base = bm * d_all[bi, k] - lo
            for b in range(bm):
                rows = bi * bm + b
                for c in range(bn):
                    data.index_put_((lut[base + (c - b)], rows), self.vals[bi, k, b, c],
                                    accumulate=True)
        return DiaMatrix(data=data, offsets=tuple(offs))
