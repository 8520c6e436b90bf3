"""The rank work of ``chip_smoke.py``'s distributed phase (J).

``chip_smoke.py`` starts the ranks with ``runtime.spawn`` (NCCL, one card
each) and calls :func:`phase_j_rank` on each; a spawned rank runs only
functions of this package, so the work lives here.  For each solve the
rank holds every kernel its shard runs (K3 at s steps and at one on the
interleaved engine's padded domain; K1 and K2 on the natural engine's)
against its plain version at the shard's own shape and times both with
CUDA events, then zeroes the
launch counters, runs the solve and reads them, and finally counts the
collectives of one CA block and the spread of its replicated R.  The
checks against oracles are made by the caller, on rank 0's answers.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ca_lanczos_tpu_torch.utils.profiling import cuda_event_ms


def _counters():
    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_pell, cuda_spmv

    return (cuda_spmv.LAUNCHES, cuda_ilv.LAUNCHES, cuda_pell.LAUNCHES)


def _zero() -> None:
    for c in _counters():
        for k in c:
            c[k] = 0


def _read() -> Dict[str, int]:
    return {k: v for c in _counters() for k, v in c.items() if v}


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    num = (got - ref).abs().amax(dim=1)
    return float((num / ref.abs().amax(dim=1)).max())


def _check(name: str, D: torch.Tensor, s: int, nbytes: int, flops: int, kern, plain,
           bound: Dict[str, float]) -> dict:
    """One kernel against its plain version on the same inputs: max error
    relative to max|plain| per output row (``bound`` by dtype), and the
    CUDA-event ms of both."""
    dt = str(D.dtype).split(".")[-1]
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, ref = (got[None],), (ref[None],)
    rows = [(g.reshape(-1, g.shape[-1]), r.reshape(-1, r.shape[-1])) for g, r in zip(got, ref)]
    err = max(_rel_err(g, r) for g, r in rows)
    abs_err = max(float((g - r).abs().max()) for g, r in rows)
    ok = all(bool(torch.isfinite(g).all()) for g, _ in rows) and err <= bound[dt]
    del got, ref, rows
    ms = cuda_event_ms(kern)
    plain_ms = cuda_event_ms(plain, reps=5, batch=2)
    return dict(name=name, dtype=dt, shape=list(D.shape), s=s, rel_err=err,
                max_abs_err=abs_err, ok=ok, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
                flops=flops)


def kernel_rows(A, s: int, coefs: np.ndarray, dtype: torch.dtype,
                bound: Dict[str, float]) -> List[dict]:
    """Every kernel that a solve on ``A`` runs on the rank's shard, at the
    shard's padded shape, against its plain version on the same inputs (a
    random x and ``coefs``): on the interleaved engine K3 at ``s`` steps
    (the CA blocks) and at one (``dist_spmv_ilv``: the locking and
    true-residual products); on the natural engine K1 at ``s`` steps and
    K2 (``dist_spmv``), in the driver state's ``dtype``.  Each row holds
    the work's bytes (each input read once, each output written once) and
    operations, for the caller's bound."""
    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_spmv

    ilv = A.ilv_engine
    D = A.ilv_data if ilv else A.planes(dtype)
    nd, m = D.shape
    g = torch.Generator(device="cpu").manual_seed(A.rank)
    X = torch.randn(m, generator=g, dtype=torch.float64).to(D.dtype).to(D.device)
    X = X / torch.linalg.norm(X)
    item = D.element_size()
    nnz = sum(m - abs(o) for o in A.offsets)
    offs = A.offsets

    def powers(k: int) -> Tuple[int, int]:
        return (nd + 1 + k + 1) * m * item, k * (2 * nnz + 4 * m)

    if ilv:
        return [
            _check("dia_powers_ilv", D, s, *powers(s),
                   lambda: cuda_ilv.dia_powers_ilv(D, X, coefs, offs, s),
                   lambda: cuda_ilv.dia_powers_ilv_ref(D, X, coefs, offs, s), bound),
            _check("dia_powers_ilv", D, 1, *powers(1),
                   lambda: cuda_ilv.dia_powers_ilv(D, X, None, offs, 1),
                   lambda: cuda_ilv.dia_powers_ilv_ref(D, X, None, offs, 1), bound),
        ]
    if cuda_spmv.k1_plan_for(offs, s, D.dtype).variant == "steps":
        raise AssertionError(f"K1 plans K2 steps at {offs}, s={s}")
    return [
        _check("dia_powers_fused", D, s, *powers(s),
               lambda: cuda_spmv.dia_powers_fused(D, X, coefs, offs, s),
               lambda: cuda_spmv.dia_powers_fused_ref(D, X, coefs, offs, s), bound),
        _check("dia_power_step", D, 1, (nd + 2) * m * item, 2 * nnz,
               lambda: cuda_spmv.dia_power_step(D, X, None, None, offs),
               lambda: cuda_spmv.dia_power_step_ref(D, X, None, None, offs), bound),
    ]


def _block_comm(A, s: int, coefs: np.ndarray, mesh) -> dict:
    """Collectives of one first block and one CA block on ``A``, and the
    spread of the replicated R across the ranks."""
    from ca_lanczos_tpu_torch.parallel import comm
    from ca_lanczos_tpu_torch.parallel.step import dist_ca_block, dist_first_block
    from ca_lanczos_tpu_torch.utils.debug import cross_device_consistency

    q = A.shard_entry(np.ones(A.n) / np.sqrt(A.n))
    Qb, _ = dist_first_block(A, q, coefs[:, 0], coefs[:, 1], s, mesh)
    comm.reset()
    _, _, R = dist_ca_block(A, Qb, coefs[:, 0], coefs[:, 1], s, mesh)
    counts = {k: v for k, v in comm.COUNTS.items()}
    counts["R_spread"] = cross_device_consistency(R)
    return counts


def _tridiag(d: np.ndarray, off: np.ndarray, dtype):
    import scipy.sparse as sp

    return sp.diags([off[:-1], d, off[:-1]], [-1, 0, 1], format="csr").astype(dtype)


def phase_j_rank(solves: List[dict], bound: Dict[str, float]) -> List[dict]:
    """Every solve of phase J on this rank, in order.  A solve is a dict:
    ``d``, ``off`` (the tridiagonal's planes, f64), ``dtype``
    ("float32"/"float64"), ``max_lanczos``, ``engine`` ("auto": the
    routed ``dist_solve_auto``; "dia": ``dist_restarted_ca_lanczos`` on the
    natural engine and the f64 polish on rank 0).  Settings are main path
    A's: n_wanted=10, s=8, tol=1e-4, max_restarts=200, polish=10,
    over_lock=3, r = ones."""
    import dataclasses

    from ca_lanczos_tpu_torch.config import Basis, LanczosConfig
    from ca_lanczos_tpu_torch.harness.auto import _polish_block
    from ca_lanczos_tpu_torch.parallel import comm
    from ca_lanczos_tpu_torch.parallel.auto import dist_solve_auto, route_dist_operator
    from ca_lanczos_tpu_torch.parallel.distributed import DistDia
    from ca_lanczos_tpu_torch.parallel.mesh import make_mesh
    from ca_lanczos_tpu_torch.parallel.restarted import dist_restarted_ca_lanczos
    from ca_lanczos_tpu_torch.parallel.step import newton_coeffs
    from ca_lanczos_tpu_torch.solvers.ca_lanczos import build_basis_matrix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh()
    cfg = LanczosConfig(n_wanted=10, s=8, tol=1e-4, max_restarts=200)
    s = cfg.s
    out = []
    for job in solves:
        t0 = time.perf_counter()
        a = _tridiag(job["d"], job["off"], np.dtype(job["dtype"]))
        n = a.shape[0]
        r = np.ones(n)
        A, fmt, route = route_dist_operator(a, mesh, s)
        build_s = time.perf_counter() - t0
        engine = fmt if job["engine"] == "auto" else job["engine"]
        Ad = DistDia.from_dia(A, mesh, s_max=s, ilv=engine == "ilv")
        A_dev = A.to(mesh.device)
        Bk = build_basis_matrix(A_dev, torch.as_tensor(r / np.sqrt(n), dtype=A_dev.dtype,
                                                       device=mesh.device), s, Basis.NEWTON)
        del A_dev
        coefs = np.stack(newton_coeffs(Bk), axis=1)
        krows = kernel_rows(Ad, s, coefs, Ad.dtype, bound)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        dist.barrier()
        _zero()
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        if job["engine"] == "auto":
            res = dist_solve_auto(a, r, job["max_lanczos"], mesh, cfg, polish=10, over_lock=3)
            eigs, label, conv = res.eigs, res.solver, res.converged
            restarts, stages, presid = res.n_restarts, dict(res.stage_seconds), res.polish_resid
            escalated = res.escalated
        else:
            c13 = dataclasses.replace(cfg, n_wanted=cfg.n_wanted + 3)
            ts = time.perf_counter()
            res = dist_restarted_ca_lanczos(A, r, job["max_lanczos"], mesh, c13,
                                            dist_format="dia")
            torch.cuda.synchronize(mesh.device)
            stages = {"solve": time.perf_counter() - ts}
            ts = time.perf_counter()
            pol = None
            if dist.get_rank() == 0:
                w, pr, _ = _polish_block(a, None, None, res.Q_conv, "largest", 10, 4,
                                         device=mesh.device)
                pol = (w[:10], pr[:10])
            eigs, presid = comm.broadcast_object(pol, mesh.device)
            stages["polish"] = time.perf_counter() - ts
            label = "dist_restarted_ca_lanczos+polish10"
            conv, restarts, escalated = res.converged, res.n_restarts, False
        torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        launches = _read()
        peak_gib = torch.cuda.max_memory_allocated(mesh.device) / 2**30
        out.append(dict(
            n=n, format=fmt, engine=engine, label=label, converged=bool(conv),
            escalated=bool(escalated), restarts=int(restarts), stages=stages, wall=wall,
            build_s=build_s, eigs=np.asarray(eigs), polish_resid=np.asarray(presid),
            launches=launches, kernels=krows, comm=_block_comm(Ad, s, coefs, mesh),
            n_local=Ad.n_local, halo=Ad.halo, ilv_m_pad=Ad.ilv_m_pad, peak_gib=peak_gib,
            notes=route.notes))
        del Ad, A, a, res
        torch.cuda.empty_cache()
    return out
