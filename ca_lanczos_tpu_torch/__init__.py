"""ca_lanczos_tpu_torch — the PyTorch/CUDA port of ``ca_lanczos_tpu``.

The JAX package beside it is the reference.  This package keeps its
module paths and public names; plain tensor code is PyTorch and the TPU's
Pallas kernels on the banded main path are hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use.  It never imports JAX.
"""

from ca_lanczos_tpu_torch.config import (
    Basis,
    LanczosConfig,
    LejaVariant,
    Orth,
    OrthParams,
    QrMethod,
    RestartStrategy,
)
from ca_lanczos_tpu_torch.ops.spmv import DenseMatrix, DiaMatrix, EllMatrix, normest, spmv
from ca_lanczos_tpu_torch.ops.matrix_powers import (
    matrix_powers_monomial,
    matrix_powers_newton,
    matrix_powers,
)
from ca_lanczos_tpu_torch.ops.qr import tsqr, cholqr
from ca_lanczos_tpu_torch.ops.orth import normalize, project, project_and_normalize
from ca_lanczos_tpu_torch.basis.leja import leja, count_multiplicities
from ca_lanczos_tpu_torch.basis.newton import newton_basis_matrix

__all__ = [
    "Basis",
    "Orth",
    "LejaVariant",
    "RestartStrategy",
    "QrMethod",
    "OrthParams",
    "LanczosConfig",
    "DiaMatrix",
    "EllMatrix",
    "DenseMatrix",
    "spmv",
    "normest",
    "matrix_powers_monomial",
    "matrix_powers_newton",
    "matrix_powers",
    "tsqr",
    "cholqr",
    "normalize",
    "project",
    "project_and_normalize",
    "leja",
    "count_multiplicities",
    "newton_basis_matrix",
]

__version__ = "0.1.0"
