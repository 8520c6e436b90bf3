"""Production entry points (solve_auto), the solver probe, run records
and the experiment harnesses.  Exports what the JAX package's ``harness``
exports, except the ``matrix_info`` summary function, which waits with
the rest of the harness utilities."""

from ca_lanczos_tpu_torch.harness.records import RunRecord, write_records, read_records
from ca_lanczos_tpu_torch.harness.matrix_info import recommend_solver
from ca_lanczos_tpu_torch.harness.auto import AutoResult, solve_auto
from ca_lanczos_tpu_torch.harness.experiments import (
    run_propagation_experiment,
    run_restart_sweep,
    run_convergence_experiment,
)

__all__ = [
    "RunRecord",
    "write_records",
    "read_records",
    "recommend_solver",
    "AutoResult",
    "solve_auto",
    "run_propagation_experiment",
    "run_restart_sweep",
    "run_convergence_experiment",
]
