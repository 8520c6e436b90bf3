"""The rank work of ``chip_smoke.py``'s distributed phases (J and K).

``chip_smoke.py`` starts the ranks with ``runtime.spawn`` (NCCL, one card
each) and calls :func:`phase_j_rank` or :func:`phase_k_rank` on each; a
spawned rank runs only functions of this package, so the work lives
here.  For each solve the rank holds every kernel its operator runs
against its plain version at the rank's own operand shapes (K3 at s
steps and at one on the interleaved engine's padded domain; K1 and K2 on
the natural engine's; K4 at s steps and at one on a DistPell's window)
and times both with CUDA events, beside one torch.sparse CSR product of
the same shard (the library yardstick), then zeroes the launch counters,
runs the solve and reads them, and counts the collectives of one CA
block and the spread of its replicated R.  The checks against oracles
are made by the caller, on rank 0's answers.
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


def _check(name: str, dt: str, shape, s: int, nbytes: int, flops: int, kern, plain,
           bound: Dict[str, float], library=None) -> dict:
    """One kernel against its plain version on the same inputs: max error
    relative to max|plain| per output row (``bound`` by dtype), and the
    CUDA-event ms of both and of ``library`` (one torch call computing
    the same product, or None)."""
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
    library_ms = None if library is None else cuda_event_ms(library)
    return dict(name=name, dtype=dt, shape=list(shape), s=s, rel_err=err,
                max_abs_err=abs_err, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                nbytes=nbytes, flops=flops)


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def dia_csr(D: torch.Tensor, offsets) -> torch.Tensor:
    """The (m x m) torch.sparse CSR of DIA planes ``D (nd, m)`` (zero
    boundary), built row-major on D's device: the library yardstick."""
    nd, m = D.shape
    offs = torch.as_tensor(sorted(offsets), device=D.device)
    order = [list(offsets).index(o) for o in sorted(offsets)]
    cols = torch.arange(m, device=D.device)[:, None] + offs[None, :]
    ok = (cols >= 0) & (cols < m)
    crow = torch.zeros(m + 1, dtype=torch.int64, device=D.device)
    crow[1:] = torch.cumsum(ok.sum(1), 0)
    return torch.sparse_csr_tensor(crow, cols[ok], D[order].T[ok], size=(m, m))


def _random_x(m: int, dtype, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    X = torch.randn(m, generator=g, dtype=torch.float64).to(dtype).to(device)
    return X / torch.linalg.norm(X)


def kernel_rows(A, s: int, coefs: np.ndarray, dtype: torch.dtype,
                bound: Dict[str, float], powers: bool = True) -> List[dict]:
    """Every kernel that a solve on ``A`` runs on the rank's shard, at the
    shard's padded shape, against its plain version on the same inputs (a
    random x and ``coefs``): on the interleaved engine K3 at ``s`` steps
    (the CA blocks) and at one (``dist_spmv_ilv``: the locking and
    true-residual products); on the natural engine K1 at ``s`` steps and
    K2 (``dist_spmv``), in the driver state's ``dtype`` (K2 alone with
    ``powers=False``).  Each row holds the work's bytes (each input read
    once, each output written once) and operations, for the caller's
    bound, and the time of one CSR product of the shard's natural planes
    (K2 and K3 at one step)."""
    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_spmv

    ilv = A.ilv_engine
    Dn = A.planes(dtype)
    D = A.ilv_data if ilv else Dn
    nd, m = D.shape
    X = _random_x(m, D.dtype, D.device, A.rank)
    item = D.element_size()
    nnz = sum(m - abs(o) for o in A.offsets)
    offs = A.offsets
    dt = _dtype_name(D.dtype)
    csr = dia_csr(Dn, offs)
    Xn = _random_x(Dn.shape[1], Dn.dtype, Dn.device, A.rank)
    library = lambda: csr @ Xn  # noqa: E731

    def work(k: int) -> Tuple[int, int]:
        return (nd + 1 + k + 1) * m * item, k * (2 * nnz + 4 * m)

    if ilv:
        return [
            _check("dia_powers_ilv", dt, D.shape, s, *work(s),
                   lambda: cuda_ilv.dia_powers_ilv(D, X, coefs, offs, s),
                   lambda: cuda_ilv.dia_powers_ilv_ref(D, X, coefs, offs, s), bound),
            _check("dia_powers_ilv", dt, D.shape, 1, *work(1),
                   lambda: cuda_ilv.dia_powers_ilv(D, X, None, offs, 1),
                   lambda: cuda_ilv.dia_powers_ilv_ref(D, X, None, offs, 1), bound, library),
        ]
    rows = []
    if powers:
        if cuda_spmv.k1_plan_for(offs, s, D.dtype).variant == "steps":
            raise AssertionError(f"K1 plans K2 steps at {offs}, s={s}")
        rows.append(_check("dia_powers_fused", dt, D.shape, s, *work(s),
                           lambda: cuda_spmv.dia_powers_fused(D, X, coefs, offs, s),
                           lambda: cuda_spmv.dia_powers_fused_ref(D, X, coefs, offs, s),
                           bound))
    rows.append(_check("dia_power_step", dt, D.shape, 1, (nd + 2) * m * item, 2 * nnz,
                       lambda: cuda_spmv.dia_power_step(D, X, None, None, offs),
                       lambda: cuda_spmv.dia_power_step_ref(D, X, None, None, offs), bound,
                       library))
    return rows


def pell_rows(A, s: int, coefs: np.ndarray, bound: Dict[str, float], csr=None) -> List[dict]:
    """K4 on a DistPell's window planes against its plain version: the s
    chained steps of the CA blocks (each writing a row of one buffer, as
    ``dist_pell._pell_powers_local`` does) and, when ``csr`` (the window
    as a torch.sparse CSR) is given, the one-step product of the locking
    and true-residual products, beside one CSR matvec."""
    from ca_lanczos_tpu_torch.ops.cuda_pell import pell_step
    from ca_lanczos_tpu_torch.ops.pell import pell_step_bytes, pell_step_ref

    W = A.A
    X = torch.zeros(W.n_x, dtype=W.dtype, device=W.device)
    X[:W.n] = _random_x(W.n, W.dtype, W.device, A.rank)
    dt = _dtype_name(W.dtype)
    need, _ = pell_step_bytes(W)
    flops = 2 * W.nnz + 4 * W.n_pad
    c = coefs

    def chain(k: int, kernel: bool):
        def run():
            V = X.new_zeros((k + 1, W.n_x))
            V[0] = X
            for j in range(k):
                prev = V[j - 1] if j else None
                if kernel:
                    pell_step(W, V[j], prev, float(c[j, 0]), float(c[j, 1]), out=V[j + 1])
                else:
                    V[j + 1] = pell_step_ref(W, V[j], prev, float(c[j, 0]), float(c[j, 1]))
            return V[1:, :W.n]
        return run

    rows = [_check("pell_step_unit", dt, W.vals.shape, s, s * need, s * flops,
                   chain(s, True), chain(s, False), bound)]
    if csr is not None:
        Xn = X[:W.n].contiguous()
        rows.append(_check("pell_step_unit", dt, W.vals.shape, 1, need, flops,
                           lambda: pell_step(W, X)[:W.n], lambda: pell_step_ref(W, X)[:W.n],
                           bound, lambda: csr @ Xn))
    return rows


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


def _measure(mesh, fn):
    """fn() with every launch counter set to 0 just before and read just
    after, the device synchronised around it: (result, launches, wall s,
    peak device GiB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    dist.barrier()
    _zero()
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - t0
    return out, _read(), wall, torch.cuda.max_memory_allocated(mesh.device) / 2**30


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
    from ca_lanczos_tpu_torch.parallel import comm
    from ca_lanczos_tpu_torch.parallel.auto import dist_solve_auto, route_dist_operator
    from ca_lanczos_tpu_torch.parallel.distributed import DistDia
    from ca_lanczos_tpu_torch.parallel.mesh import make_mesh
    from ca_lanczos_tpu_torch.parallel.restarted import dist_restarted_ca_lanczos
    from ca_lanczos_tpu_torch.parallel.step import newton_coeffs
    from ca_lanczos_tpu_torch.solvers.ca_lanczos import build_basis_matrix
    from ca_lanczos_tpu_torch.solvers.polish import f64_operator

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

        def solve():
            if job["engine"] == "auto":
                res = dist_solve_auto(a, r, job["max_lanczos"], mesh, cfg, polish=10,
                                      over_lock=3)
                return (res.eigs, res.solver, res.converged, res.n_restarts,
                        dict(res.stage_seconds), res.polish_resid, res.escalated)
            c13 = dataclasses.replace(cfg, n_wanted=cfg.n_wanted + 3)
            ts = time.perf_counter()
            res = dist_restarted_ca_lanczos(A, r, job["max_lanczos"], mesh, c13,
                                            dist_format="dia")
            torch.cuda.synchronize(mesh.device)
            stages = {"solve": time.perf_counter() - ts}
            ts = time.perf_counter()
            pol = None
            if dist.get_rank() == 0:
                w, pr, _ = f64_operator(a, None, None, "largest",
                                        device=mesh.device)[0](res.Q_conv, 10, 4)
                pol = (w[:10], pr[:10])
            eigs, presid = comm.broadcast_object(pol, mesh.device)
            stages["polish"] = time.perf_counter() - ts
            return (eigs, "dist_restarted_ca_lanczos+polish10", res.converged, res.n_restarts,
                    stages, presid, False)

        ((eigs, label, conv, restarts, stages, presid, escalated), launches, wall,
         peak_gib) = _measure(mesh, solve)
        out.append(dict(
            n=n, format=fmt, engine=engine, label=label, converged=bool(conv),
            escalated=bool(escalated), restarts=int(restarts), stages=stages, wall=wall,
            build_s=build_s, eigs=np.asarray(eigs), polish_resid=np.asarray(presid),
            launches=launches, kernels=krows, comm=_block_comm(Ad, s, coefs, mesh),
            n_local=Ad.n_local, halo=Ad.halo, ilv_m_pad=Ad.ilv_m_pad, peak_gib=peak_gib,
            notes=route.notes))
        del Ad, A, a
        torch.cuda.empty_cache()
    return out


def ring_planes(E, w: int) -> np.ndarray:
    """The (2w+1, n) circulant planes of a ring-banded ELL operator:
    ``data[d, i] = H[i, (i + d - w) mod n]``."""
    vals, cols = E.vals.cpu().numpy(), E.cols.cpu().numpy()
    n = vals.shape[0]
    k = np.mod(cols - np.arange(n)[:, None] + n // 2, n) - n // 2
    if np.abs(k[vals != 0]).max() > w:
        raise ValueError(f"operator reaches past ring distance {w}")
    data = np.zeros((2 * w + 1, n), vals.dtype)
    for j in range(vals.shape[1]):
        np.add.at(data, (k[:, j] + w, np.arange(n)), vals[:, j])
    return data


def _k_general(mesh, pell_path: str, bound) -> dict:
    """K(a) and K(b): the PELL oracle matrix through ``dist_solve_auto``
    (routed with max_diags=16 to "pell") and ``dist_ca_lanczos`` on its
    EllMatrix as a DistEll and as a DistPell."""
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.config import Basis, LanczosConfig
    from ca_lanczos_tpu_torch.ops.pell import PellMatrix
    from ca_lanczos_tpu_torch.parallel.auto import dist_solve_auto, route_dist_operator
    from ca_lanczos_tpu_torch.parallel.dist_ell import ell_shard_planes
    from ca_lanczos_tpu_torch.parallel.dist_pell import DistPell, window_csr
    from ca_lanczos_tpu_torch.parallel.driver import dist_ca_lanczos
    from ca_lanczos_tpu_torch.parallel.step import newton_coeffs
    from ca_lanczos_tpu_torch.solvers.ca_lanczos import build_basis_matrix

    a = sp.load_npz(pell_path).tocsr()
    n = a.shape[0]
    cfg = LanczosConfig(n_wanted=10, s=8, tol=1e-4, max_restarts=200)
    s = cfg.s
    sync = lambda: torch.cuda.synchronize(mesh.device)  # noqa: E731
    t0 = time.perf_counter()
    E, fmt, route = route_dist_operator(a, mesh, s, max_diags=16)
    t_route = time.perf_counter() - t0
    # The rank's window, as DistPell.from_ell makes it, in its two stages.
    t0 = time.perf_counter()
    sv, sc, halo, _ = ell_shard_planes(E, mesh.size, s, ranks=[mesh.rank])
    wcsr = window_csr(sv[0], sc[0])
    del sv, sc
    t_part = time.perf_counter() - t0
    t0 = time.perf_counter()
    W = PellMatrix.from_scipy(wcsr, device=mesh.device, encoding="unit")
    sync()
    t_enc = time.perf_counter() - t0
    Dp = DistPell(A=W, halo=halo, n=n, mesh=mesh, s_max=s)
    lib = torch.sparse_csr_tensor(torch.as_tensor(wcsr.indptr.astype(np.int64)),
                                  torch.as_tensor(wcsr.indices.astype(np.int64)),
                                  torch.as_tensor(wcsr.data), size=wcsr.shape,
                                  device=mesh.device)
    E_dev = E.to(mesh.device)
    Bk = build_basis_matrix(E_dev, torch.as_tensor(np.ones(n) / np.sqrt(n), dtype=E.dtype,
                                                   device=mesh.device), s, Basis.NEWTON)
    del E_dev
    coefs = np.stack(newton_coeffs(Bk), axis=1)
    krows = pell_rows(Dp, s, coefs, bound, lib)
    del lib, wcsr
    res, launches, wall, peak = _measure(mesh, lambda: dist_solve_auto(
        a, np.ones(n), 32, mesh, cfg, polish=10, over_lock=3, max_diags=16))
    out_a = dict(n=n, nnz=int(a.nnz), format=fmt, route_notes=route.notes, m=Dp.m, halo=halo,
                 n_local=Dp.n_local, K=W.k_slots, sw=W.sw, n_win=W.n_win, route_s=t_route,
                 partition_s=t_part, encode_s=t_enc, label=res.solver,
                 converged=bool(res.converged), escalated=bool(res.escalated),
                 restarts=int(res.n_restarts), stages=dict(res.stage_seconds), wall=wall,
                 eigs=np.asarray(res.eigs), polish_resid=np.asarray(res.polish_resid),
                 launches=launches, kernels=krows, peak_gib=peak,
                 comm=_block_comm(Dp, s, coefs, mesh))
    del res, Dp, W

    # K(b): s = 4, 24 steps, monomial, the same EllMatrix as DistEll / DistPell
    t0 = time.perf_counter()
    Db = DistPell.from_ell(E, mesh, s_max=4)
    sync()
    t_b = time.perf_counter() - t0
    krows_b = pell_rows(Db, 4, np.zeros((4, 2)), bound)
    (r_ell, r_pell), launches_b, wall_b, peak_b = _measure(mesh, lambda: (
        dist_ca_lanczos(E, np.ones(n), 4, 24, mesh, dist_format="ell"),
        dist_ca_lanczos(Db, np.ones(n), 4, 24, mesh)))
    out_b = dict(ritz_ell=np.sort(np.linalg.eigvalsh(r_ell.T))[::-1],
                 ritz_pell=np.sort(np.linalg.eigvalsh(r_pell.T))[::-1],
                 ops=(type(r_ell.op).__name__, type(r_pell.op).__name__), halo=Db.halo,
                 m=Db.m, from_ell_s=t_b, launches=launches_b, kernels=krows_b, wall=wall_b,
                 peak_gib=peak_b)
    del r_ell, r_pell, Db, E, a
    return {"a": out_a, "b": out_b}


def _k_bsr(mesh, bsr_path: str, bound) -> dict:
    """K(c): BASELINE.json configs[4] through the distributed drivers:
    DistBsr powers beside the single card's, ``dist_restarted_ca_lanczos``
    on the BsrMatrix, ``dist_sstep_lanczos`` on its f64 DIA form beside
    the single card's ``sstep_lanczos`` (rank 0)."""
    from ca_lanczos_tpu_torch.config import LanczosConfig
    from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
    from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers_monomial
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
    from ca_lanczos_tpu_torch.parallel.dist_bsr import DistBsr, dist_bsr_matrix_powers
    from ca_lanczos_tpu_torch.parallel.dist_sstep import dist_sstep_lanczos
    from ca_lanczos_tpu_torch.parallel.distributed import DistDia
    from ca_lanczos_tpu_torch.parallel.restarted import dist_restarted_ca_lanczos
    from ca_lanczos_tpu_torch.solvers.sstep import sstep_lanczos

    z = np.load(bsr_path)
    dev = mesh.device
    A = BsrMatrix(vals=torch.as_tensor(z["vals"], device=dev),
                  cols=torch.as_tensor(z["cols"], device=dev))
    n = A.n
    x = np.asarray(np.random.default_rng(1).standard_normal(n), np.float32)
    x /= np.linalg.norm(x)
    t0 = time.perf_counter()
    Ad = DistBsr.from_bsr(A, mesh, s_max=4)
    torch.cuda.synchronize(dev)
    t_part = time.perf_counter() - t0
    xl = Ad.shard_vector(x)
    xd = torch.as_tensor(x, device=dev)
    V = dist_bsr_matrix_powers(Ad, xl, 4, None, None, mesh)
    Vg = Ad.gather_columns(V)
    V1 = matrix_powers_monomial(A, xd, 4).cpu().numpy()
    gap = float(np.max(np.abs(Vg - V1).max(0) / np.abs(V1).max(0)))
    del V, Vg, V1
    dist_ms = cuda_event_ms(lambda: dist_bsr_matrix_powers(Ad, xl, 4, None, None, mesh),
                            reps=5, batch=2)
    single_ms = cuda_event_ms(lambda: matrix_powers_monomial(A, xd, 4), reps=5, batch=2)
    halo_b, n_local = Ad.halo_b, Ad.n_local
    del Ad, xl
    cfg = LanczosConfig(s=4, n_wanted=3, tol=1e-4, max_restarts=30)
    res, launches, wall, peak = _measure(mesh, lambda: dist_restarted_ca_lanczos(
        A, x, 16, mesh, cfg))
    out = dict(n=n, tiles=list(A.vals.shape), halo_b=halo_b, n_local=n_local,
               partition_s=t_part, powers_gap=gap, dist_powers_ms=dist_ms,
               single_powers_ms=single_ms, converged=bool(res.converged),
               restarts=int(res.n_restarts), eigs=np.asarray(res.eigs), wall=wall,
               launches=launches, peak_gib=peak, top=z["top"])
    del res
    D = A.to_dia()
    D64 = DiaMatrix(data=D.data.double(), offsets=D.offsets)
    del D, A
    # dist_sstep_lanczos's own shard: K1 (monomial, s = 4) and K2 in f64
    Dd = DistDia.from_dia(D64, mesh, s_max=4)
    krows = kernel_rows(Dd, 4, np.zeros((4, 2)), torch.float64, bound)
    del Dd
    x64 = x.astype(np.float64)
    rs, launches_s, wall_s, peak_s = _measure(mesh, lambda: dist_sstep_lanczos(
        D64, x64, 4, 3, mesh))
    T_single, single_s = None, None
    if dist.get_rank() == 0:
        t0 = time.perf_counter()
        T_single = sstep_lanczos(D64, torch.as_tensor(x64, device=dev), 4, 3).T
        torch.cuda.synchronize(dev)
        single_s = time.perf_counter() - t0
    out.update(sstep_T=rs.T, sstep_T_single=T_single, sstep_wall=wall_s,
               sstep_single_s=single_s, sstep_launches=launches_s, sstep_peak_gib=peak_s,
               nd=len(D64.offsets), kernels=krows)
    del rs, D64
    torch.cuda.empty_cache()
    return out


def _k_prop(mesh, n: int, bound) -> dict:
    """K(d): ``dist_propagate_split`` of G(b)'s oscillator as a 5-offset
    circulant DistDia (periodic, s_max=1) for 20 time steps, Krylov 24, at
    G(b)'s dt; rank 0 also runs the single card's ``propagate_split`` on
    G(b)'s operator (``make_operator(prefer="dia")`` of the CSR)."""
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.ops.formats import make_operator
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, normest
    from ca_lanczos_tpu_torch.parallel import comm
    from ca_lanczos_tpu_torch.parallel.dist_prop import dist_propagate_split
    from ca_lanczos_tpu_torch.parallel.distributed import DistDia
    from ca_lanczos_tpu_torch.solvers.propagators import propagate_split
    from ca_lanczos_tpu_torch.utils.matrices import gaussian_packet, harmonic_oscillator

    dev = mesh.device
    steps, kdim, dt = 20, 24, 0.025
    He, xg = harmonic_oscillator(n, device="cpu")
    psi0 = gaussian_packet(xg).astype(np.complex128)
    Hb = None
    if dist.get_rank() == 0:
        rows = np.repeat(np.arange(n), He.vals.shape[1])
        csr = sp.csr_matrix((He.vals.numpy().ravel(), (rows, He.cols.numpy().ravel())), (n, n))
        Hb, _ = make_operator(csr, prefer="dia", device=dev)
        del csr
    # G(b)'s time step: dt scaled by ||H_512|| / ||H_n||
    dtb = comm.on_root(lambda: dt * normest(harmonic_oscillator(512, device=dev)[0])
                       / normest(Hb), dev)
    Ad = DistDia.from_dia(DiaMatrix(data=torch.as_tensor(ring_planes(He, 2)),
                                    offsets=(-2, -1, 0, 1, 2)), mesh, s_max=1, periodic=True)
    del He
    krows = kernel_rows(Ad, 1, None, torch.float64, bound, powers=False)
    psi, launches, wall, peak = _measure(mesh, lambda: dist_propagate_split(
        Ad, psi0, dtb, steps, mesh, krylov_dim=kdim))
    out = dict(n=n, dt=dtb, steps=steps, krylov=kdim, n_local=Ad.n_local, halo=Ad.halo,
               wall=wall, launches=launches, kernels=krows, peak_gib=peak,
               drift=float(np.linalg.norm(psi) / np.linalg.norm(psi0) - 1.0))
    if dist.get_rank() == 0:
        t0 = time.perf_counter()
        ref = propagate_split(Hb, torch.as_tensor(psi0, device=dev), dtb, steps, kdim)
        ref = ref.cpu().numpy()
        out.update(single_s=time.perf_counter() - t0,
                   diff=float(np.abs(psi - ref).max() / np.abs(ref).max()),
                   single_drift=float(np.linalg.norm(ref) / np.linalg.norm(psi0) - 1.0),
                   moved=float(np.abs(ref - psi0).max() / np.abs(ref).max()))
    del Ad, Hb
    torch.cuda.empty_cache()
    return out


def phase_k_rank(inputs: Dict[str, str], bound: Dict[str, float]) -> dict:
    """Phase K on this rank (chip_smoke.py's docstring): ``inputs`` names
    the files the caller wrote ("pell": the PELL oracle matrix, f32 CSR;
    "bsr": configs[4]'s planted tiles, cols and top), and "osc_n" the
    oscillator's rows.  Returns {"a", "b", "c", "d"}: each sub-phase's
    figures, launch counts and kernel rows."""
    from ca_lanczos_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh()
    out = _k_general(mesh, inputs["pell"], bound)
    out["c"] = _k_bsr(mesh, inputs["bsr"], bound)
    out["d"] = _k_prop(mesh, int(inputs["osc_n"]), bound)
    return out
