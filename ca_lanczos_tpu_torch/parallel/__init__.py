"""The distributed layer on ``torch.distributed`` (counterpart of
``ca_lanczos_tpu/parallel``): row-sharded operators (DIA on the natural
(K1) and interleaved (K3) engines, ELL, PELL through K4, BSR), halo
exchanges, all-reduced block orthogonalization, the CA / restarted / IRL
/ s-step drivers, the split propagator and ``dist_solve_auto``.  One
process per rank (SPMD); ``runtime.spawn`` starts them on one host.

Exports the JAX package's ``__all__``.  Importing it starts no process
group.
"""

from ca_lanczos_tpu_torch.parallel.mesh import (
    CHIP,
    HOST,
    ROWS,
    make_hier_mesh,
    make_mesh,
    replicated,
    row_axes,
    row_sharding,
    row_spec,
)
from ca_lanczos_tpu_torch.parallel.dist_orth import (
    local_cholqr,
    local_gram,
    local_norm,
    local_project,
    local_tsqr,
    psum_rows,
)
from ca_lanczos_tpu_torch.parallel.distributed import (
    DistDia,
    dist_ilv_decode,
    dist_ilv_encode,
    dist_matrix_powers,
    dist_matrix_powers_ilv,
    dist_matrix_powers_rows,
    dist_spmv,
    ilv_pad_state,
    ilv_padded_powers,
    ilv_refresh_ghosts,
    ilv_statics,
    ilv_unpad_state,
    ilv_zero_ghosts,
)
from ca_lanczos_tpu_torch.parallel.step import (
    dist_ca_block,
    dist_first_block,
    newton_coeffs,
    partition_operator,
)
from ca_lanczos_tpu_torch.parallel.auto import dist_solve_auto, route_dist_operator
from ca_lanczos_tpu_torch.parallel.driver import DistCaLanczosResult, dist_ca_lanczos, dist_lanczos
from ca_lanczos_tpu_torch.parallel.dist_bsr import DistBsr, dist_bsr_matrix_powers
from ca_lanczos_tpu_torch.parallel.dist_ell import DistEll, dist_ell_matrix_powers
from ca_lanczos_tpu_torch.parallel.dist_pell import DistPell, dist_pell_matrix_powers
from ca_lanczos_tpu_torch.parallel.dist_irl import dist_impl_restarted_ca_lanczos
from ca_lanczos_tpu_torch.parallel.dist_sstep import dist_sstep_lanczos
from ca_lanczos_tpu_torch.parallel.restarted import dist_restarted_ca_lanczos
from ca_lanczos_tpu_torch.parallel.runtime import initialize_multihost, scaling_sweep

__all__ = [
    "make_mesh",
    "make_hier_mesh",
    "row_sharding",
    "row_spec",
    "row_axes",
    "replicated",
    "psum_rows",
    "ROWS",
    "HOST",
    "CHIP",
    "DistDia",
    "dist_ilv_decode",
    "dist_ilv_encode",
    "ilv_pad_state",
    "ilv_padded_powers",
    "ilv_refresh_ghosts",
    "ilv_statics",
    "ilv_unpad_state",
    "ilv_zero_ghosts",
    "dist_matrix_powers",
    "dist_matrix_powers_ilv",
    "dist_matrix_powers_rows",
    "dist_spmv",
    "local_tsqr",
    "local_cholqr",
    "local_gram",
    "local_project",
    "local_norm",
    "dist_first_block",
    "dist_ca_block",
    "newton_coeffs",
    "partition_operator",
    "dist_solve_auto",
    "route_dist_operator",
    "dist_ca_lanczos",
    "dist_lanczos",
    "DistCaLanczosResult",
    "DistBsr",
    "DistEll",
    "dist_ell_matrix_powers",
    "DistPell",
    "dist_bsr_matrix_powers",
    "dist_pell_matrix_powers",
    "dist_impl_restarted_ca_lanczos",
    "dist_sstep_lanczos",
    "dist_restarted_ca_lanczos",
    "initialize_multihost",
    "scaling_sweep",
]
