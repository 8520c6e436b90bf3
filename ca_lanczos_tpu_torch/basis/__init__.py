from ca_lanczos_tpu_torch.basis.leja import (
    leja,
    nonmodified_leja,
    modified_leja,
    real_leja,
    complex_leja,
    count_multiplicities,
)
from ca_lanczos_tpu_torch.basis.newton import newton_basis_matrix

__all__ = [
    "leja",
    "nonmodified_leja",
    "modified_leja",
    "real_leja",
    "complex_leja",
    "count_multiplicities",
    "newton_basis_matrix",
]
