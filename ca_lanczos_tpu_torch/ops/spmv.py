"""Sparse operator formats and SpMV — the L0 layer of the PyTorch port.

Counterpart of ``ca_lanczos_tpu/ops/spmv.py``.  The operators are frozen
dataclasses holding tensors; every ``matvec`` is plain PyTorch (shifted
slices, gather-sum, matmul) and runs on any device.

The ``spmv`` seam sends a 1-D product on a CUDA device to the kernel
registered for the operator's type in ``CUDA_MATVEC``: ``ops.cuda_spmv``
(imported with the ``ops`` package) registers the DIA step kernel K2 for
``DiaMatrix``, one launch where eager PyTorch spends 2*ndiags+1, and
``ops.cuda_pell`` the PELL step kernels K4/K5 for ``PellMatrix``
(``ops.pell``).  This module imports no kernel module.

Constructors put their tensors on ``device="cuda"`` unless told otherwise.

Plane convention (as in the JAX package): ``data[d, i] = A[i, i + offsets[d]]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
from ca_lanczos_tpu_torch.ops.pell import PellMatrix


def _dia_matvec(offsets: Tuple[int, ...], data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Shifted-slice DIA product for a vector (n,) or multivector (n, m);
    sums the diagonals in ``offsets`` order."""
    n = data.shape[1]
    wl = max(0, -min(offsets)) if offsets else 0
    wr = max(0, max(offsets)) if offsets else 0
    xp = torch.nn.functional.pad(x.movedim(0, -1), (wl, wr)).movedim(-1, 0)
    y = torch.zeros_like(x)
    for d, k in enumerate(offsets):
        seg = xp[wl + k : wl + k + n]
        y = y + (data[d] * seg if x.ndim == 1 else data[d][:, None] * seg)
    return y


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal (DIA) sparse matrix, row-indexed: ``data[d, i] = A[i, i +
    offsets[d]]`` (zero where the column index is out of range)."""

    data: torch.Tensor  # (ndiags, n)
    offsets: Tuple[int, ...]

    @property
    def n(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        return sum(self.n - abs(k) for k in self.offsets)

    def to(self, device) -> "DiaMatrix":
        return DiaMatrix(data=self.data.to(device), offsets=self.offsets)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _dia_matvec(self.offsets, self.data, x)

    def to_dense(self) -> torch.Tensor:
        n = self.n
        out = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        rows = torch.arange(n, device=self.device)
        for d, k in enumerate(self.offsets):
            cols = rows + k
            valid = (cols >= 0) & (cols < n)
            out[rows[valid], cols[valid]] += self.data[d][valid]
        return out

    @staticmethod
    def from_dense(a, tol: float = 0.0, device="cuda") -> "DiaMatrix":
        a = np.asarray(a)
        n = a.shape[0]
        offsets = []
        data = []
        for k in range(-n + 1, n):
            diag = np.diagonal(a, k)
            if np.any(np.abs(diag) > tol):
                offsets.append(k)
                row = np.zeros(n, a.dtype)
                if k >= 0:
                    row[: n - k] = diag
                else:
                    row[-k:] = diag
                data.append(row)
        return DiaMatrix(
            data=torch.as_tensor(np.stack(data), device=device), offsets=tuple(offsets)
        )


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELLPACK: ``vals[i, j]`` multiplies ``x[cols[i, j]]``; padding carries
    ``vals == 0`` with an in-range column index."""

    vals: torch.Tensor  # (n, k)
    cols: torch.Tensor  # (n, k) int64

    @property
    def n(self) -> int:
        return self.vals.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        return self.vals.shape[0] * self.vals.shape[1]

    def exact_nnz(self) -> int:
        """Stored entries that are not zero (``nnz`` counts the padding)."""
        return int((self.vals != 0).sum())

    def to(self, device) -> "EllMatrix":
        return EllMatrix(vals=self.vals.to(device), cols=self.cols.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        gathered = x[self.cols]  # (n, k) or (n, k, m)
        if x.ndim == 1:
            return torch.sum(self.vals * gathered, dim=1)
        return torch.sum(self.vals[..., None] * gathered, dim=1)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros((self.n, self.n), dtype=self.dtype, device=self.device)
        rows = torch.arange(self.n, device=self.device)[:, None].expand_as(self.cols)
        out.index_put_((rows, self.cols), self.vals, accumulate=True)
        return out

    @staticmethod
    def from_dense(a, device="cuda") -> "EllMatrix":
        import scipy.sparse as sp

        return EllMatrix.from_scipy(sp.csr_matrix(np.asarray(a)), device=device)

    @staticmethod
    def from_scipy(a, device="cuda") -> "EllMatrix":
        """Convert a scipy.sparse matrix to ELL (vectorized, O(nnz))."""
        import scipy.sparse as sp

        csr = sp.csr_matrix(a)
        csr.sort_indices()
        n = csr.shape[0]
        counts = np.diff(csr.indptr)
        k = max(1, int(counts.max()))
        rows = np.repeat(np.arange(n), counts)
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        vals = np.zeros((n, k), csr.dtype)
        cols = np.zeros((n, k), np.int64)
        vals[rows, slot] = csr.data
        cols[rows, slot] = csr.indices
        return EllMatrix(
            vals=torch.as_tensor(vals, device=device),
            cols=torch.as_tensor(cols, device=device),
        )


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense operator; SpMV is a matmul.  Oracle/testing path."""

    a: torch.Tensor  # (n, n)

    @property
    def n(self) -> int:
        return self.a.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.a.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.a.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    @property
    def nnz(self) -> int:
        return self.a.shape[0] * self.a.shape[1]

    def to(self, device) -> "DenseMatrix":
        return DenseMatrix(a=self.a.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.a @ x

    def to_dense(self) -> torch.Tensor:
        return self.a


# IlvDiaMatrix (ops.cuda_ilv) also satisfies this protocol (duck-typed on
# matvec/shape/dtype/device/nnz).
Operator = Union[DiaMatrix, EllMatrix, DenseMatrix, PellMatrix, BsrMatrix]


# Kernel for a 1-D product on a CUDA device, by operator type (module
# docstring); it takes (A, x) and returns A @ x.
CUDA_MATVEC: Dict[type, Callable] = {}


def spmv(A: Operator, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for any supported operator (reference seam: SpMV.m:6-8)."""
    kernel = CUDA_MATVEC.get(type(A))
    if kernel is not None and x.ndim == 1 and x.device.type == "cuda":
        return kernel(A, x)
    return A.matvec(x)


def normest(A: Operator, tol: float = 1.0e-6, max_iters: int = 200) -> float:
    """2-norm estimate via power iteration until the estimate changes by
    less than ``tol`` relative (MATLAB ``normest`` analogue).  The start
    vector is the JAX package's, bit for bit (``default_rng(0x5EED)``)."""
    n = A.shape[0]
    dt = torch.promote_types(A.dtype, torch.float32)
    rng = np.random.default_rng(0x5EED)

    def fresh():
        v = torch.as_tensor(rng.standard_normal(n), dtype=dt, device=A.device)
        return v / torch.linalg.norm(v)

    v = fresh()
    est = 0.0
    for _ in range(max_iters):
        w = spmv(A, v)
        nrm = torch.linalg.norm(w)
        v = w / nrm
        new = float(nrm)
        if new == 0.0 or not np.isfinite(new):
            # Landed in (or near) the null space: restart fresh.
            v = fresh()
            est = 0.0
            continue
        if abs(new - est) <= tol * max(new, 1e-300):
            return new
        est = new
    return est
