"""Test fixtures, diagnostics, checkpoints, Matrix Market I/O, RCM
reordering, profiling and debug checks.

Exports what the JAX package's ``utils`` exports.
"""

from ca_lanczos_tpu_torch.utils.matrices import (
    diag_spectrum,
    laplacian_1d,
    laplacian_2d,
    harmonic_oscillator,
    gaussian_packet,
)
from ca_lanczos_tpu_torch.utils.diagnostics import (
    ritz_residual_norms,
    orth_error_fro,
    orth_error_block,
    OmegaRecurrence,
)
from ca_lanczos_tpu_torch.utils.checkpoint import RestartCheckpoint
from ca_lanczos_tpu_torch.utils.debug import (
    assert_finite,
    check_deterministic,
    cross_device_consistency,
)
from ca_lanczos_tpu_torch.utils.mmio import load_mtx, load_operator, save_mtx
from ca_lanczos_tpu_torch.utils.profiling import (
    RooflineReport,
    measure_ca_iteration_throughput,
    measure_powers_throughput,
    roofline_audit,
)
from ca_lanczos_tpu_torch.utils.reorder import Reordering, rcm_reorder

__all__ = [
    "diag_spectrum",
    "laplacian_1d",
    "laplacian_2d",
    "harmonic_oscillator",
    "gaussian_packet",
    "ritz_residual_norms",
    "orth_error_fro",
    "orth_error_block",
    "OmegaRecurrence",
    "RestartCheckpoint",
    "assert_finite",
    "check_deterministic",
    "cross_device_consistency",
    "load_mtx",
    "load_operator",
    "save_mtx",
    "RooflineReport",
    "measure_ca_iteration_throughput",
    "measure_powers_throughput",
    "roofline_audit",
    "Reordering",
    "rcm_reorder",
]
