"""Experiment harnesses mirroring the reference's L4 scripts.

Counterpart of ``ca_lanczos_tpu/harness/experiments.py``; the records are
the same ``RunRecord`` JSON as the JAX package's.

* ``run_propagation_experiment`` — the runLanczos.m experiment: propagate
  the harmonic-oscillator Gaussian packet with standard / CA-Newton /
  CA-monomial propagators on ``device``, report wall times and errors vs
  the expm oracle (runLanczos.m:66-214).
* ``run_restart_sweep`` — the test_restarted_ca_lanczos_all_matrices.m
  sweep: restarted CA-Lanczos over (s, orth) grids per matrix, recording
  max ritz norm / orth error / eig error vs oracle / restarts / time
  (:36-69).
* ``run_convergence_experiment`` — per-iteration convergence +
  orthogonality traces on diagonal spectra
  (test_convergence_diagonal_matrices.m:9-21,
  lanczos_l_convergence_orthogonality.m:44-81).

Wall times end with the device synchronised.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.config import Basis, LanczosConfig, Orth
from ca_lanczos_tpu_torch.harness.records import RunRecord
from ca_lanczos_tpu_torch.ops.spmv import Operator
from ca_lanczos_tpu_torch.solvers.ca_lanczos import ca_lanczos
from ca_lanczos_tpu_torch.solvers.propagators import propagate
from ca_lanczos_tpu_torch.solvers.restarted import restarted_ca_lanczos
from ca_lanczos_tpu_torch.utils.matrices import gaussian_packet, harmonic_oscillator


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_propagation_experiment(
    n: int = 512,
    dt: float = 0.025,
    n_steps: int = 200,
    krylov_dim: int = 24,
    s: int = 6,
    tol: float = 1.0e-10,
    methods: Sequence[Tuple[str, str, Basis]] = (
        ("std-lanczos", "lanczos", Basis.NEWTON),
        ("ca-newton", "ca", Basis.NEWTON),
        ("ca-monomial", "ca", Basis.MONOMIAL),
    ),
    oracle: bool = True,
    device="cuda",
) -> List[RunRecord]:
    """runLanczos.m: N=512, dt=0.025, 200 steps, 24 Krylov steps, s=6."""
    H, x = harmonic_oscillator(n, device=device)
    psi0 = torch.as_tensor(gaussian_packet(x), dtype=torch.complex128, device=device)

    psi_ref = None
    if oracle:
        import scipy.linalg

        Hd = H.to_dense().cpu().numpy()
        psi_ref = scipy.linalg.expm(-1j * dt * n_steps * Hd) @ psi0.cpu().numpy()

    records = []
    for name, method, basis in methods:
        _sync(device)
        t0 = time.perf_counter()
        psi = propagate(
            H, psi0, dt, n_steps, krylov_dim=krylov_dim, method=method, s=s,
            tol=tol, basis=basis,
        )
        _sync(device)
        wall = time.perf_counter() - t0
        rec = RunRecord(
            matrix=f"harmonic_oscillator_{n}", solver=name, s=s, basis=str(Basis(basis).value),
            wall_s=wall,
            extra={"dt": dt, "n_steps": n_steps, "krylov_dim": krylov_dim},
        )
        if psi_ref is not None:
            rec.extra["max_abs_err"] = float(np.max(np.abs(psi.cpu().numpy() - psi_ref)))
        records.append(rec)
    return records


def run_restart_sweep(
    matrices: Dict[str, Operator],
    s_values: Iterable[int] = (1, 2, 4, 6, 8, 10),
    orths: Iterable[Orth] = (Orth.LOCAL, Orth.FULL, Orth.PERIODIC, Orth.SELECTIVE),
    basis: Basis = Basis.NEWTON,
    max_lanczos: int = 60,
    n_wanted: int = 10,
    tol: float = 1.0e-8,
    oracles: Optional[Dict[str, np.ndarray]] = None,
    seed: int = 0,
) -> List[RunRecord]:
    """test_restarted_ca_lanczos_all_matrices.m sweep (s in {1,2,4,6,8,10},
    all four orth modes, newton basis, maxvecs=60, 10 wanted eigs).  The
    start vector is the JAX package's (``default_rng(seed).random``,
    float64) on each operator's device."""
    records = []
    rng = np.random.default_rng(seed)
    for name, A in matrices.items():
        n = A.shape[0]
        r = torch.as_tensor(rng.random(n), dtype=torch.float64, device=A.device)  # :27
        for s in s_values:
            for orth in orths:
                cfg = LanczosConfig(
                    s=s, basis=basis, orth=orth, n_wanted=n_wanted, tol=tol
                )
                _sync(A.device)
                t0 = time.perf_counter()
                try:
                    res = restarted_ca_lanczos(A, r, max_lanczos, cfg)
                    _sync(A.device)
                    wall = time.perf_counter() - t0
                    rec = RunRecord(
                        matrix=name, solver="restarted_ca_lanczos", s=s,
                        basis=str(Basis(basis).value), orth=str(Orth(orth).value),
                        n_wanted=n_wanted,
                        max_ritz_norm=float(np.max(res.conv_rnorms)) if res.conv_rnorms.size else None,
                        max_orth_err=float(np.max(res.orth_err)) if res.orth_err.size else None,
                        n_restarts=res.n_restarts,
                        converged=bool(res.converged),
                        wall_s=wall,
                    )
                    if oracles and name in oracles:
                        exact = np.sort(np.asarray(oracles[name]))[::-1][: len(res.eigs)]
                        got = np.sort(res.eigs)[::-1]
                        rec.max_eig_err = float(np.max(np.abs(got - exact)))
                except Exception as e:  # record failures instead of dying mid-sweep
                    rec = RunRecord(
                        matrix=name, solver="restarted_ca_lanczos", s=s,
                        basis=str(Basis(basis).value), orth=str(Orth(orth).value),
                        converged=False, extra={"error": repr(e)},
                    )
                records.append(rec)
    return records


def run_convergence_experiment(
    A: Operator,
    name: str,
    n_iters: int = 120,
    s: int = 4,
    basis: Basis = Basis.NEWTON,
    orth: Orth = Orth.PERIODIC,
) -> Tuple[RunRecord, np.ndarray, np.ndarray]:
    """Per-iteration Ritz residual and orthogonality traces
    (test_convergence_diagonal_matrices.m:9-21).  Returns
    (record, ritz_rnorm history, orth_err history)."""
    n = A.shape[0]
    r = torch.ones((n,), dtype=torch.float64, device=A.device)
    _sync(A.device)
    t0 = time.perf_counter()
    res = ca_lanczos(A, r, s, n_iters, basis=basis, orth=orth, diagnostics=True)
    _sync(A.device)
    wall = time.perf_counter() - t0
    rec = RunRecord(
        matrix=name, solver="ca_lanczos", s=s, basis=str(Basis(basis).value),
        orth=str(Orth(orth).value),
        max_ritz_norm=float(np.nanmin(res.ritz_rnorm[-1])) if res.ritz_rnorm is not None else None,
        max_orth_err=float(np.max(res.orth_err)) if res.orth_err is not None else None,
        wall_s=wall,
        extra={"n_reorth": res.n_reorth},
    )
    return rec, res.ritz_rnorm, res.orth_err
