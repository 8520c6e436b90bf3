"""Carry an operator of the JAX package across to the port.

``operator_from_numpy`` reads a JAX operator's leaves through
``np.asarray`` (no ``jax`` import) and builds the port's operator with the
same values on ``device``, so both packages compute on identical
operators.  Recognised by their fields:

* ``PellMatrix`` — ``span_row`` and the other planes and statics, taken
  as they are (the two packages' planes are the same bits);
* ``IlvDiaMatrix`` — ``dia_data``, ``offsets``, ``n_rows``; rebuilt in the
  port's interleaved layout (needs the normal-layout companion, i.e. a
  carrier made with ``keep_dia=True``);
* ``DiaMatrix`` — ``data``, ``offsets``;
* ``DenseMatrix`` — ``a``;
* ``BsrMatrix`` — ``vals`` (4-D tiles), ``cols``; tested before ELL, whose
  fields it shares;
* ``EllMatrix`` — ``vals`` (2-D), ``cols``.
"""

from __future__ import annotations

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
from ca_lanczos_tpu_torch.ops.cuda_ilv import IlvDiaMatrix
from ca_lanczos_tpu_torch.ops.pell import PellMatrix
from ca_lanczos_tpu_torch.ops.spmv import DenseMatrix, DiaMatrix, EllMatrix


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.array(x), dtype=dtype, device=device)


def operator_from_numpy(A, device="cuda"):
    """The port's counterpart of the JAX operator ``A`` (see module doc)."""
    if hasattr(A, "span_row"):
        return PellMatrix(
            vals=_t(A.vals, device), lidx=_t(A.lidx, device), cbase=_t(A.cbase, device),
            span_row=_t(A.span_row, device), n=int(A.n), tile=int(A.tile),
            k_slots=int(A.k_slots), sw=int(A.sw), nnz_count=int(A.nnz_count),
            n_win=int(A.n_win), enc=str(A.enc),
        )
    if hasattr(A, "dia_data") and hasattr(A, "n_rows"):
        if A.dia_data is None:
            raise ValueError("IlvDiaMatrix without dia_data: build it with keep_dia=True")
        dia = DiaMatrix(data=_t(A.dia_data, device), offsets=tuple(int(o) for o in A.offsets))
        if dia.n != int(A.n_rows):
            raise ValueError(f"dia_data has {dia.n} rows, n_rows={A.n_rows}")
        return IlvDiaMatrix.from_dia(dia, keep_dia=True)
    if hasattr(A, "data") and hasattr(A, "offsets"):
        return DiaMatrix(data=_t(A.data, device), offsets=tuple(int(o) for o in A.offsets))
    if hasattr(A, "vals") and hasattr(A, "cols") and np.ndim(A.vals) == 4:
        return BsrMatrix(vals=_t(A.vals, device), cols=_t(A.cols, device, torch.int64))
    if hasattr(A, "vals") and hasattr(A, "cols"):
        return EllMatrix(vals=_t(A.vals, device), cols=_t(A.cols, device, torch.int64))
    if hasattr(A, "a"):
        return DenseMatrix(a=_t(A.a, device))
    raise TypeError(f"no port counterpart for {type(A).__name__}")
