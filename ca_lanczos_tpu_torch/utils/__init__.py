"""Test fixtures, diagnostics, checkpoints and carry-across helpers.

Exports what the JAX package's ``utils`` exports from the modules the port
has (``matrices``, ``diagnostics``, ``checkpoint``).
"""

from ca_lanczos_tpu_torch.utils.matrices import diag_spectrum, laplacian_1d, laplacian_2d
from ca_lanczos_tpu_torch.utils.diagnostics import (
    ritz_residual_norms,
    orth_error_fro,
    orth_error_block,
    OmegaRecurrence,
)
from ca_lanczos_tpu_torch.utils.checkpoint import RestartCheckpoint

__all__ = [
    "diag_spectrum",
    "laplacian_1d",
    "laplacian_2d",
    "ritz_residual_norms",
    "orth_error_fro",
    "orth_error_block",
    "OmegaRecurrence",
    "RestartCheckpoint",
]
