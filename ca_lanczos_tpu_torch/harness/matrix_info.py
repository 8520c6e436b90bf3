"""Corpus metadata and the solver-selection probe (counterpart of
``ca_lanczos_tpu/harness/matrix_info.py``; reference get_matrix_info.m,
which writes size / condest / normest / extreme eigenvalues for the
105-matrix corpus)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ca_lanczos_tpu_torch.config import Orth
from ca_lanczos_tpu_torch.ops.spmv import Operator, normest
from ca_lanczos_tpu_torch.solvers.lanczos import lanczos


def recommend_solver(
    A: Operator,
    n_wanted: int = 10,
    probe_steps: int = 40,
    cluster_rel_gap: float = 1.0e-3,
    seed: int = 0,
) -> Dict[str, Any]:
    """Driver-selection PRIOR from a short full-orth Lanczos probe: the
    explicit thick restart (``restarted_ca_lanczos``) fails on
    clustered-top spectra, where the implicitly-restarted driver with
    locking (``impl_restarted_ca_lanczos``) converges.  The probe measures
    the relative gaps among the top ``n_wanted`` Ritz values; it only
    orders ``solve_auto``'s escalation ladder.  The start vector is the
    JAX package's (``default_rng(seed).random(n)``).

    Returns {"driver", "clustered", "min_rel_gap", "top_ritz"}.
    """
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    r = torch.as_tensor(rng.random(n), dtype=getattr(A, "dtype", torch.float64),
                        device=getattr(A, "device", "cpu"))
    steps = min(probe_steps, n - 1)
    boot = lanczos(A, r, steps, Orth.FULL)
    d = np.linalg.eigvalsh(np.asarray(boot.T)[:steps, :steps])
    scale = max(float(np.abs(d).max()), np.finfo(np.float64).tiny)
    top = np.sort(d)[::-1][: min(n_wanted, len(d))]
    gaps = np.abs(np.diff(top)) / scale
    min_gap = float(gaps.min()) if gaps.size else 1.0
    clustered = min_gap < cluster_rel_gap
    return {
        "driver": "impl_restarted_ca_lanczos" if clustered else "restarted_ca_lanczos",
        "clustered": clustered,
        "min_rel_gap": min_gap,
        "top_ritz": top,
    }


def matrix_info(A: Operator, name: str = "", dense_cutoff: int = 2000) -> Dict[str, Any]:
    """Size, nnz, 2-norm estimate and extreme eigenvalues.

    Small operators (n <= dense_cutoff) get exact dense eigenvalues (in
    the operator's dtype, on the host) and condition number; large ones
    get the power-iteration norm estimate only (matching
    get_matrix_info.m's normest/eigs usage)."""
    n = A.shape[0]
    info: Dict[str, Any] = {"name": name, "n": n, "nnz": int(A.nnz), "normest": float(normest(A))}
    if n <= dense_cutoff:
        d = np.linalg.eigvalsh(A.to_dense().cpu().numpy())
        info["eig_max"] = float(d[-1])
        info["eig_min"] = float(d[0])
        nonzero = np.abs(d)[np.abs(d) > 0]
        info["cond"] = float(np.abs(d).max() / nonzero.min()) if nonzero.size else np.inf
    return info
