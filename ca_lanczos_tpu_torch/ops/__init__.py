"""Operators, matrix-powers kernels and QR factorizations.

Exports what the JAX package's ``ops`` exports, except ``pick_tile``
(the Pallas grid's tile picker; K1's launch is planned by
``ops.cuda_spmv.k1_plan``)."""

# Register the DIA (K2) and PELL (K4/K5) kernels behind ops.spmv.spmv for
# CUDA vectors.
from ca_lanczos_tpu_torch.ops import cuda_pell, cuda_spmv  # noqa: F401
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, EllMatrix, DenseMatrix, spmv, normest
from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
from ca_lanczos_tpu_torch.ops.matrix_powers import (
    matrix_powers,
    matrix_powers_monomial,
    matrix_powers_newton,
)
from ca_lanczos_tpu_torch.ops.cuda_spmv import matrix_powers_dia_pallas
from ca_lanczos_tpu_torch.ops.pell import PellMatrix, matrix_powers_pell, pell_apply
from ca_lanczos_tpu_torch.ops.formats import (
    OperatorRoute,
    dia_from_scipy,
    load_operator_npz,
    make_operator,
    save_operator,
)
from ca_lanczos_tpu_torch.ops.qr import tsqr, cholqr
from ca_lanczos_tpu_torch.ops.orth import normalize, project, project_and_normalize

__all__ = [
    "DiaMatrix",
    "EllMatrix",
    "DenseMatrix",
    "BsrMatrix",
    "spmv",
    "normest",
    "matrix_powers",
    "matrix_powers_monomial",
    "matrix_powers_newton",
    "matrix_powers_dia_pallas",
    "PellMatrix",
    "matrix_powers_pell",
    "pell_apply",
    "OperatorRoute",
    "dia_from_scipy",
    "load_operator_npz",
    "make_operator",
    "save_operator",
    "tsqr",
    "cholqr",
    "normalize",
    "project",
    "project_and_normalize",
]
