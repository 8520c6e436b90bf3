"""Operators, matrix-powers kernels and QR factorizations."""

# Register the DIA (K2) and PELL (K4/K5) kernels behind ops.spmv.spmv for
# CUDA vectors.
from ca_lanczos_tpu_torch.ops import cuda_pell, cuda_spmv  # noqa: F401
from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix

__all__ = ["BsrMatrix"]
