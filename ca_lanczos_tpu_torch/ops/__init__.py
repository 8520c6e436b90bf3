"""Operators, matrix-powers kernels and QR factorizations."""

# Registers the DIA kernel behind ops.spmv.spmv for CUDA vectors.
from ca_lanczos_tpu_torch.ops import cuda_spmv  # noqa: F401
