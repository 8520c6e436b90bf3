"""ca_lanczos_tpu_torch — the PyTorch/CUDA port of ``ca_lanczos_tpu``.

The JAX package beside it is the reference.  This package keeps its
module paths and public names; plain tensor code is PyTorch and the TPU's
Pallas kernels on the banded main path are hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use.  It never imports JAX.
"""

from ca_lanczos_tpu_torch.config import Basis, LanczosConfig, LejaVariant, Orth, OrthParams
from ca_lanczos_tpu_torch.ops.spmv import DenseMatrix, DiaMatrix, EllMatrix, normest, spmv

__all__ = [
    "Basis",
    "LanczosConfig",
    "LejaVariant",
    "Orth",
    "OrthParams",
    "DenseMatrix",
    "DiaMatrix",
    "EllMatrix",
    "normest",
    "spmv",
]

__version__ = "0.1.0"
