"""Lanczos drivers and the f64 polish (``solvers.polish``).

Exports what the JAX package's ``solvers`` exports.
"""

from ca_lanczos_tpu_torch.solvers.lanczos import lanczos, LanczosResult
from ca_lanczos_tpu_torch.solvers.ca_lanczos import (
    ca_lanczos,
    CaLanczosResult,
    build_basis_matrix,
    monomial_basis_matrix,
    newton_shifts_bootstrap,
)
from ca_lanczos_tpu_torch.solvers.propagators import (
    lanczos_prop,
    ca_lanczos_prop,
    propagate,
    PropResult,
    lanczos_prop_split,
    propagate_split,
    propagate_split_fused,
    SplitPropResult,
)
from ca_lanczos_tpu_torch.solvers.sstep import sstep_lanczos, sstep_lanczos_prop, SstepResult
from ca_lanczos_tpu_torch.solvers.arnoldi import arnoldi
from ca_lanczos_tpu_torch.solvers.implicitly_restarted import (
    impl_restarted_ca_lanczos,
    IRLResult,
    qrstep,
)
from ca_lanczos_tpu_torch.solvers.fused_restarted import (
    fused_restarted_ca_lanczos,
    FusedRestartedResult,
)
from ca_lanczos_tpu_torch.solvers.restarted import (
    restarted_lanczos,
    restarted_ca_lanczos,
    RestartedResult,
)

__all__ = [
    "lanczos",
    "LanczosResult",
    "ca_lanczos",
    "CaLanczosResult",
    "build_basis_matrix",
    "monomial_basis_matrix",
    "newton_shifts_bootstrap",
    "restarted_lanczos",
    "restarted_ca_lanczos",
    "RestartedResult",
    "fused_restarted_ca_lanczos",
    "FusedRestartedResult",
    "lanczos_prop",
    "ca_lanczos_prop",
    "propagate",
    "PropResult",
    "lanczos_prop_split",
    "propagate_split",
    "propagate_split_fused",
    "SplitPropResult",
    "sstep_lanczos",
    "sstep_lanczos_prop",
    "SstepResult",
    "arnoldi",
    "impl_restarted_ca_lanczos",
    "IRLResult",
    "qrstep",
]
