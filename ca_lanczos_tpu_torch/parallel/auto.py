"""Distributed one-call eigensolve: raw matrix -> routed distributed drivers.

Counterpart of ``ca_lanczos_tpu/parallel/auto.py``.  The halo design needs
BOUNDED column spread (|col - row| <= bw with s*bw < rows per shard), so
the route is

  1. diagonal-sparse      -> DiaMatrix: the interleaved engine (K3) when
                             the shard admits it, else the natural one (K1)
  2. bounded bandwidth    -> an EllMatrix: "pell" when the matrix
                             PELL-encodes (DistPell: K4 on each rank's
                             window), else "ell" (DistEll: the gather)
  3. unbounded spread     -> RCM reorder, then 1-2 on the permuted matrix

``dist_solve_auto`` runs SPMD: every rank calls it with the same
arguments.  The probe runs on rank 0's device and its driver order is
broadcast, so every rank walks the same ladder; the f64 polish runs on
rank 0's device against the raw matrix and its numbers are broadcast.
Every rank returns the same eigs, converged, n_restarts, solver and
polish_resid; rank 0 alone returns Q_conv (the others None).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ca_lanczos_tpu_torch.config import LanczosConfig
from ca_lanczos_tpu_torch.harness.auto import AutoResult
from ca_lanczos_tpu_torch.ops.formats import OperatorRoute, dia_from_scipy
from ca_lanczos_tpu_torch.ops.spmv import EllMatrix
from ca_lanczos_tpu_torch.parallel import comm
from ca_lanczos_tpu_torch.parallel.mesh import Mesh
from ca_lanczos_tpu_torch.utils.spans import stage


def route_dist_operator(
    a,
    mesh: Mesh,
    s_max: int,
    *,
    max_diags: int = 64,
    dia_waste_cap: float = 8.0,
    allow_reorder: bool = True,
) -> Tuple[object, str, OperatorRoute]:
    """Route a square scipy/dense matrix for row sharding over ``mesh``.

    Returns (host operator with CPU planes, dist_format, route).  The halo
    design needs s_max * bandwidth < rows per shard; a matrix that breaks
    it is RCM-reordered, and one neither form can host raises ValueError."""
    import scipy.sparse as sp

    P = mesh.size
    csr = sp.csr_matrix(a) if sp.issparse(a) else sp.csr_matrix(np.asarray(a))
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("square matrices only")
    csr.sum_duplicates()
    csr.sort_indices()
    n = csr.shape[0]
    nnz = int(csr.nnz)
    n_local = -(-n // P)
    notes = []

    def _try(csr_x):
        A = dia_from_scipy(csr_x, max_diags=max_diags, waste_cap=dia_waste_cap, device="cpu")
        coo = csr_x.tocoo()
        bw = int(np.max(np.abs(coo.row - coo.col))) if nnz else 0
        if A is not None and s_max * bw < n_local:
            from ca_lanczos_tpu_torch.parallel.distributed import dist_ilv_admissible

            ok, why = dist_ilv_admissible(A, P, s_max)
            if ok:
                notes.append("ilv engine: interleaved padded-domain local step")
                return A, "ilv", bw
            notes.append(f"ilv engine inadmissible ({why}): natural local step")
            return A, "dia", bw
        if s_max * bw < n_local:
            from ca_lanczos_tpu_torch.ops.pell import PellMatrix

            E = EllMatrix.from_scipy(csr_x, device="cpu")
            try:
                PellMatrix.from_scipy(csr_x, device="cpu")
                return E, "pell", bw
            except ValueError as e:
                notes.append(f"pell rejected: {e}")
                return E, "ell", bw
        return None, "", bw

    A, fmt, bw0 = _try(csr)
    if A is not None:
        notes.append(f"bandwidth {bw0} fits {P}-shard halo (s_max={s_max})")
        return A, fmt, OperatorRoute(fmt, None, notes, nnz, bw0, bw0)
    if not allow_reorder:
        raise ValueError(
            f"bandwidth {bw0}: s_max*bw >= {n_local} rows/shard and reordering is disabled")
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = np.array(reverse_cuthill_mckee(csr, symmetric_mode=True))
    csr_p = csr[perm][:, perm].tocsr()
    csr_p.sort_indices()
    A, fmt, bw1 = _try(csr_p)
    notes.append(f"rcm: bandwidth {bw0} -> {bw1}")
    if A is None:
        raise ValueError(
            f"matrix cannot be row-sharded over {P} devices: RCM bandwidth {bw1} "
            f"still needs halo {s_max * bw1} >= {n_local} rows/shard (lower s, use "
            "fewer shards, or run the single-card route)")
    return A, fmt, OperatorRoute(fmt, perm, notes, nnz, bw0, bw1)


def dist_solve_auto(
    a,
    r,
    max_lanczos: int,
    mesh: Mesh,
    cfg: Optional[LanczosConfig] = None,
    probe_steps: int = 40,
    which: str = "largest",
    polish: int = 0,
    over_lock: int = 0,
    polish_depth: int = 4,
    **route_kwargs,
) -> AutoResult:
    """The distributed ``solve_auto``: route ``a`` for row sharding, probe
    the spectrum to order the drivers (``recommend_solver``: clustered tops
    go implicit-first), run the ladder until a driver converges
    (``harness.auto.escalate``), decode Q_conv through any RCM
    permutation, and with ``polish``/``over_lock`` polish the gathered
    block in f64 against the raw matrix (``solvers.polish.polish_block``
    on rank 0).  SPMD (module docstring).
    ``stage_seconds`` holds route, probe, solve and polish (rank 0's
    clock, each stage ending with the device synchronised)."""
    from ca_lanczos_tpu_torch.harness.auto import escalate, ladder
    from ca_lanczos_tpu_torch.harness.matrix_info import recommend_solver
    from ca_lanczos_tpu_torch.parallel.dist_irl import dist_impl_restarted_ca_lanczos
    from ca_lanczos_tpu_torch.parallel.driver import root_eval
    from ca_lanczos_tpu_torch.parallel.restarted import dist_restarted_ca_lanczos
    from ca_lanczos_tpu_torch.solvers.polish import polish_block

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or LanczosConfig()
    times = {}
    route = None
    raw = None
    dist_format = "auto"
    with stage("route", times, mesh.device):
        if not hasattr(a, "matvec"):
            raw = a
            a, dist_format, route = route_dist_operator(a, mesh, cfg.s, **route_kwargs)
            r = route.apply(np.asarray(r))
    if (polish > 0 or over_lock > 0) and raw is None:
        raise ValueError(
            "polish/over_lock need an f64 operator source: pass the raw "
            "scipy matrix to dist_solve_auto")
    n_want0 = cfg.n_wanted
    if over_lock:
        cfg = dataclasses.replace(cfg, n_wanted=cfg.n_wanted + over_lock)
    if which not in ("largest", "smallest"):
        raise ValueError(f"which must be 'largest' or 'smallest', got {which!r}")
    if which == "smallest":
        from ca_lanczos_tpu_torch.ops.formats import negate_operator

        a = negate_operator(a)

    def _run(name, c, m=None):
        budget = m or max_lanczos
        if name == "restarted_ca_lanczos":
            return dist_restarted_ca_lanczos(a, r, budget, mesh, c, dist_format=dist_format)
        return dist_impl_restarted_ca_lanczos(
            a, r, budget, mesh, n_wanted=c.n_wanted, s=c.s, basis=c.basis, tol=c.tol,
            max_restarts=c.max_restarts, dist_format=dist_format,
            mixed_precision=bool(c.orth_params.mixed_precision))

    with stage("probe", times, mesh.device):
        first = root_eval(mesh, a, lambda Ad: recommend_solver(
            Ad, n_wanted=cfg.n_wanted, probe_steps=probe_steps)["driver"])
    with stage("solve", times, mesh.device):
        res, solver, escalated = escalate(_run, ladder(cfg, first, max_lanczos))
    solver = "dist_" + solver
    Q = res.Q_conv
    if route is not None and route.perm is not None and Q is not None:
        Q = route.restore(Q)
    eigs = np.asarray(res.eigs)
    presid = None
    converged, passes = bool(res.converged), 0
    if polish > 0 and Q is not None and Q.shape[1] > 0:
        with stage("polish", times, mesh.device):
            out = None
            if dist.get_rank() == 0:
                w, pr, Q, passes, settled = polish_block(
                    raw, None, route, Q, which, polish, polish_depth, n_want0,
                    device=mesh.device)
                out = (w, pr, passes, settled)
            else:
                Q = None
            eigs, presid, passes, settled = comm.broadcast_object(out, mesh.device)
        solver = solver + f"+polish{polish}"
        converged = converged and settled
    elif dist.get_rank() != 0:
        Q = None
    if which == "smallest":
        eigs = -eigs
    return AutoResult(eigs=eigs, Q_conv=Q, converged=converged,
                      n_restarts=int(res.n_restarts), solver=solver, escalated=escalated,
                      route=route, polish_resid=presid, polish_passes=passes,
                      stage_seconds=times)


def solve_rank(a, r, max_lanczos: int, cfg: LanczosConfig, n_hosts: int = 0,
               kw: Optional[dict] = None) -> dict:
    """One rank of a distributed solve started by ``runtime.spawn`` (the
    CLI's ``solve --mesh``): builds the flat or hierarchical mesh over the
    process group, runs ``dist_solve_auto(..., **kw)`` and returns its
    record fields."""
    from ca_lanczos_tpu_torch.parallel.mesh import make_hier_mesh, make_mesh

    P = dist.get_world_size()
    mesh = make_hier_mesh(n_hosts, P // n_hosts) if n_hosts else make_mesh(P)
    res = dist_solve_auto(a, r, max_lanczos, mesh, cfg, **(kw or {}))
    return {
        "format": res.route.format if res.route else None,
        "reordered": bool(res.route and res.route.perm is not None),
        "route_notes": res.route.notes if res.route else [],
        "solver": res.solver,
        "escalated": res.escalated,
        "converged": res.converged,
        "n_restarts": res.n_restarts,
        "eigs": [float(v) for v in np.sort(np.asarray(res.eigs))[::-1]],
    }
