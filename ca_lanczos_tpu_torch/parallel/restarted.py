"""Distributed explicitly-restarted CA-Lanczos.

Counterpart of ``ca_lanczos_tpu/parallel/restarted.py``: the flagship
driver (restarted_ca_lanczos.m) with every n-sized array row-sharded.
Each inner CA block is one step on every rank (halo powers, two-pass CGS
against the previous block AND the locked basis, TSQR); Ritz locking and
restart control are O((st)^2) host math that every rank repeats on the
same all-reduced numbers, so every rank takes the same decisions.

The locked basis ``Q_conv`` keeps a FIXED width (2*n_wanted columns,
zero beyond nconv): projecting against zero columns is a no-op, so the
block step has one shape for the whole run, as in the JAX package.

Checkpoints are written by rank 0 and read by every rank.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ca_lanczos_tpu_torch.config import Basis, LanczosConfig, QrMethod, RestartStrategy
from ca_lanczos_tpu_torch.ops.spmv import normest
from ca_lanczos_tpu_torch.parallel.dist_orth import local_gram, local_norm, local_project
from ca_lanczos_tpu_torch.parallel.distributed import DistDia, _coefs, dist_spmv, dist_spmv_ilv
from ca_lanczos_tpu_torch.parallel.mesh import Mesh
from ca_lanczos_tpu_torch.parallel.step import _powers, local_rows, newton_coeffs, orth_qr
from ca_lanczos_tpu_torch.solvers._block import block_T, extend_T, first_block_T
from ca_lanczos_tpu_torch.solvers.ca_lanczos import build_basis_matrix, monomial_basis_matrix
from ca_lanczos_tpu_torch.solvers.restarted import (
    RestartedResult,
    _finalize,
    _lock_converged,
    _verify_floor,
    _verify_gate,
    _wanted_converged,
)

# Lockless cycles tolerated before a random restart (stagnation guard).
_STALL_CYCLES = 5


def _dist_spmv_any(Adist, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One distributed product; on the interleaved engine x is
    padded-domain state and so is the result.  DistDia: ``dist_spmv``
    (K2) or ``dist_spmv_ilv`` (K3 at s = 1); DistEll / DistPell / DistBsr:
    column 1 of their s = 1 powers, as in the JAX package."""
    if isinstance(Adist, DistDia):
        if Adist.ilv_engine:
            return dist_spmv_ilv(Adist, x, mesh)
        return dist_spmv(Adist, x, mesh)
    return local_rows(Adist, x, _coefs(None, None, 1), 1, mesh, include_q=False)[0]


def _dist_first_block_locked(A, q, Qconv, diag, sub, s: int, mesh: Mesh,
                             qr_method: str = "tsqr", safe: bool = False, key: int = 0,
                             mp: bool = False):
    """First CA block of a restart cycle: powers -> TSQR -> lock against
    Q_conv (restarted_ca_lanczos.m:311-319).  ``safe`` normalizes through
    ``local_qr_safe``.  Returns (Qb, R, rank)."""
    V = _powers(A, q, _coefs(diag, sub, s), s, mesh)
    if safe:
        Qb, R, rank = orth_qr(A, V, qr_method, mp, mesh, safe=True, key=key)
    else:
        Qb, R = orth_qr(A, V, qr_method, mp, mesh)
        rank = V.shape[1]
    Qb, _ = local_project(Qconv, Qb, passes=2, mp=mp, mesh=mesh)
    Qb, _ = orth_qr(A, Qb, qr_method, mp, mesh)  # renormalize (projectAndNormalize)
    return Qb, R, rank


def _dist_ca_block_locked(A, Q_prev, Qconv, diag, sub, s: int, mesh: Mesh,
                          qr_method: str = "tsqr", safe: bool = False, key: int = 0,
                          mp: bool = False):
    """CA block k>1 with locking: project against the previous s+1 columns
    AND the padded converged basis (restarted_ca_lanczos.m:324).
    Returns (Q_new, Rkk, R)."""
    V = _powers(A, Q_prev[:, -1], _coefs(diag, sub, s), s, mesh)
    Y, Rkk = local_project(Q_prev, V[:, 1:], passes=2, mp=mp, mesh=mesh)
    Y, _ = local_project(Qconv, Y, passes=1, mp=mp, mesh=mesh)
    if safe:
        Q_new, R, _ = orth_qr(A, Y, qr_method, mp, mesh, safe=True, key=key)
    else:
        Q_new, R = orth_qr(A, Y, qr_method, mp, mesh)
    return Q_new, Rkk, R


def _dist_reorth(A, Qhist, X, mesh: Mesh, qr_method: str = "tsqr", mp: bool = False):
    """Re-orthogonalize X against the zero-padded cycle history (two CGS
    passes + renormalize); its R factors are discarded, as the reference's
    extra projectAndNormalize's are (restarted_ca_lanczos.m:333, :544)."""
    Y, _ = local_project(Qhist, X, passes=2, mp=mp, mesh=mesh)
    Q, _ = orth_qr(A, Y, qr_method, mp, mesh)
    return Q


def _dist_ritz_vector(Q_blocks: torch.Tensor, w) -> torch.Tensor:
    """x = Q_blocks @ w for this rank's rows (no collective)."""
    return Q_blocks @ torch.as_tensor(np.asarray(w), dtype=Q_blocks.dtype,
                                      device=Q_blocks.device)


def _deflate_start(q: torch.Tensor, Qconv: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Two CGS passes of the start vector against the padded locked basis,
    then renormalize; zero columns are no-ops."""
    for _ in range(2):
        G = local_gram(Qconv, q[:, None], mesh=mesh)[:, 0]
        q = q - Qconv @ torch.as_tensor(G, dtype=q.dtype, device=q.device)
    return q / local_norm(q, mesh)


def _bootstrap(A, q_host: np.ndarray, s: int, basis: Basis, mesh: Mesh) -> np.ndarray:
    """Bk of the run: the Newton bootstrap on the whole host operator runs
    on rank 0's device and is broadcast."""
    from ca_lanczos_tpu_torch.parallel.driver import root_eval

    if basis == Basis.MONOMIAL:
        return monomial_basis_matrix(s)
    return root_eval(mesh, A, lambda Ad: build_basis_matrix(
        Ad, torch.as_tensor(q_host, dtype=Ad.dtype, device=Ad.device), s, basis))


def dist_restarted_ca_lanczos(
    A,
    r,
    max_lanczos: int,
    mesh: Mesh,
    config: LanczosConfig = LanczosConfig(),
    checkpoint_path=None,
    resume_from=None,
    safe_qr: bool = False,
    dist_format: str = "auto",
) -> RestartedResult:
    """Row-sharded restarted CA-Lanczos (the flagship, across ranks).

    Matches ``solvers.restarted.restarted_ca_lanczos`` with the block CGS
    always two passes.  Orth modes: LOCAL; FULL (every block
    re-orthogonalized against the zero-padded cycle history); PERIODIC
    (host omega recurrence triggers that reorth,
    restarted_ca_lanczos.m:531-546); SELECTIVE (converged Ritz vectors in a
    fixed-width padded basis joined to Q_conv in the projections,
    restarted_ca_lanczos.m:436-454).

    ``checkpoint_path``: rank 0 writes the restart-boundary state after
    every restart (``utils.checkpoint.RestartCheckpoint``, gathered Q_conv
    and start vector); ``resume_from`` continues from such a file on every
    rank.  ``safe_qr`` normalizes blocks through ``local_qr_safe``.
    ``dist_format="ilv"`` runs the whole restart machine on the
    interleaved engine; the true residuals ride ``dist_spmv_ilv``.
    Every rank returns the same result, Q_conv gathered (n, k)."""
    from ca_lanczos_tpu_torch.config import Orth
    from ca_lanczos_tpu_torch.parallel.driver import _as_host, root_eval
    from ca_lanczos_tpu_torch.parallel.step import partition_operator
    from ca_lanczos_tpu_torch.utils.diagnostics import OmegaRecurrence

    s = config.s
    basis = Basis(config.basis)
    orth = Orth(config.orth)
    norm_A = root_eval(mesh, A, normest)
    tol = config.tol * norm_A
    rng = np.random.default_rng(config.seed)

    r_np = _as_host(r).astype(np.float64)
    q_host = r_np / np.linalg.norm(r_np)
    Bk = _bootstrap(A, q_host, s, basis, mesh)
    diag, sub = newton_coeffs(Bk)

    Adist = partition_operator(A, mesh, s_max=s, dist_format=dist_format)
    n = A.n
    q = Adist.shard_entry(q_host)
    dtype = q.dtype

    iters = max_lanczos // s
    if iters == 0:
        raise ValueError(f"max_lanczos={max_lanczos} < s={s}")
    m = s * iters

    # The locked basis and the histories keep the state's dtype (the JAX
    # package's natural engine keeps them f64, which is f32 on a TPU
    # without x64).
    hist_dtype = dtype
    lock_cap = 2 * config.n_wanted
    Qconv = Adist.state_zeros(lock_cap, dtype=hist_dtype)

    conv_eigs: List[float] = []
    conv_rnorms: List[float] = []
    orth_err: List[float] = []
    rnorm_rows: List[np.ndarray] = []
    nconv = 0
    n_restarts = 0
    restart = True
    stall = 0

    if resume_from is not None:
        from ca_lanczos_tpu_torch.utils.checkpoint import RestartCheckpoint

        ck = RestartCheckpoint.load(resume_from)
        n_restarts = ck.n_restarts
        nconv = ck.nconv
        conv_eigs = list(ck.conv_eigs)
        conv_rnorms = list(ck.conv_rnorms)
        orth_err = list(ck.orth_err)
        rnorm_rows = list(ck.rnorm_rows)
        Bk = ck.Bk
        diag, sub = newton_coeffs(Bk)
        if ck.Q_conv is not None:
            qc = np.zeros((n, lock_cap))
            qc[:, : ck.Q_conv.shape[1]] = ck.Q_conv
            Qconv = Adist.state_zeros(lock_cap, dtype=hist_dtype)
            Qconv[:] = Adist.shard_entry(qc)
        q = Adist.shard_entry(np.asarray(ck.q))
        rng.bit_generator.state = ck.rng_state
        restart = nconv < config.n_wanted

    safe_key = int(config.seed)
    _EPS = float(np.finfo(np.float64).eps)
    qr_m = QrMethod(config.orth_params.qr_method).value
    mp = bool(config.orth_params.mixed_precision)

    while restart and n_restarts < config.max_restarts:
        n_restarts += 1
        b = np.zeros(iters)
        blocks: List[torch.Tensor] = []
        Qhist = (Adist.state_zeros(m + 1, dtype=hist_dtype)
                 if orth in (Orth.FULL, Orth.PERIODIC, Orth.SELECTIVE) else None)
        omega = OmegaRecurrence(norm_A) if orth == Orth.PERIODIC else None
        r_cap = config.n_wanted + 4
        QRpad = Adist.state_zeros(r_cap, dtype=hist_dtype) if orth == Orth.SELECTIVE else None
        nritz = 0
        norm_sqrt_eps = norm_A * np.sqrt(_EPS)

        def proj_basis():
            return Qconv if QRpad is None else torch.cat([Qconv, QRpad], dim=1)

        if nconv:
            # Deflate the start against the locked basis: the powers block
            # re-amplifies any locked component and T is recovered from R
            # factors taken before the Q_conv projection.
            q = _deflate_start(q, Qconv, mesh)
        safe_key += 1
        Qb, Rk, first_rank = _dist_first_block_locked(
            Adist, q, proj_basis(), diag, sub, s, mesh, qr_m, safe=safe_qr, key=safe_key,
            mp=mp)
        breakdown = safe_qr and int(first_rank) <= 1
        blocks.append(Qb)
        rcond = 1e-10 if safe_qr else None
        T, b[0] = first_block_T(Rk, Bk, s, rcond=rcond)
        if Qhist is not None:
            Qhist[:, : s + 1] = Qb
        for k in range(2, iters + 1):
            safe_key += 1
            Q_new, Rkk, R = _dist_ca_block_locked(
                Adist, blocks[-1], proj_basis(), diag, sub, s, mesh, qr_m,
                safe=safe_qr, key=safe_key, mp=mp)
            Tk, b[k - 1], _ = block_T(Rkk, R, Bk, b[k - 2], s, rcond=rcond)
            T = extend_T(T, Tk, b[k - 2], b[k - 1], s)

            if orth == Orth.FULL:
                Q_new = _dist_reorth(Adist, Qhist, Q_new, mesh, qr_m, mp=mp)
            elif orth == Orth.PERIODIC:
                alpha_d = np.diagonal(T[: s * k, : s * k]).copy()
                beta_d = np.diagonal(T[: s * k + 1, : s * k], -1).copy()
                omega.update(alpha_d, beta_d)
                if omega.max_error_block(s) >= np.sqrt(_EPS / (k * s)):
                    Q_new = _dist_reorth(Adist, Qhist, Q_new, mesh, qr_m)
                    omega.reset_block(s)

            if Qhist is not None:
                lo = (k - 1) * s + 1
                Qhist[:, lo: lo + s] = Q_new
            blocks.append(torch.cat([blocks[-1][:, -1:], Q_new], dim=1))

            if orth == Orth.SELECTIVE:
                sk = s * k
                d_k, Vp_k = np.linalg.eigh(T[:sk, :sk])
                conv = [i for i in range(sk)
                        if b[k - 1] * abs(Vp_k[sk - 1, i]) < norm_sqrt_eps][:r_cap]
                if len(conv) > nritz:
                    nritz = len(conv)
                    for j, i in enumerate(conv):
                        w = np.zeros(m + 1)
                        w[:sk] = Vp_k[:, i]
                        QRpad[:, j] = _dist_ritz_vector(Qhist, w)

        # The cycle's basis aligned with T's q0..q_{m-1}: block 0 gives all
        # s+1 columns, later blocks their s new ones.
        Q_cycle = torch.cat([blocks[0]] + [B[:, 1:] for B in blocks[1:]], dim=1)[:, :m]

        d, Vp = np.linalg.eigh(T[:m, :m])
        beta_m = T[m, m - 1]
        ritz_norms = beta_m * np.abs(Vp[m - 1, :])
        k_new, d, Vp, ritz_norms = _lock_converged(d, Vp, ritz_norms, tol,
                                                   lam_bound=1.05 * norm_A)
        # Qconv holds lock_cap pairs: keep the wanted end when more converge.
        if k_new > lock_cap - nconv:
            order = np.argsort(d[:k_new])
            if RestartStrategy(config.restart_strategy) != RestartStrategy.SMALLEST:
                order = order[::-1]
            keep = np.concatenate([order, np.arange(k_new, len(d))])
            d, Vp, ritz_norms = d[keep], Vp[:, keep], ritz_norms[keep]
            k_new = lock_cap - nconv

        k_est = k_new
        verified = 0
        for i in range(k_new):
            x = _dist_ritz_vector(Q_cycle, Vp[:, i])
            true_abs = local_norm(_dist_spmv_any(Adist, x, mesh) - float(d[i]) * x, mesh)
            if config.verify_locked and true_abs > _verify_gate(
                    ritz_norms[i], norm_A,
                    floor=_verify_floor(dtype, config.tol, safe_qr=safe_qr)):
                continue
            Qconv[:, nconv + verified] = x
            conv_eigs.append(float(d[i]))
            conv_rnorms.append(float(ritz_norms[i]))
            verified += 1
        k_new = verified
        rnorm_rows.append(np.asarray(
            conv_rnorms + [np.nan] * (config.n_wanted - len(conv_rnorms)))[: config.n_wanted])
        nconv += k_new
        stall = stall + 1 if (safe_qr and k_new == 0) else 0

        restart = _wanted_converged(conv_eigs, d[k_est:], config.restart_strategy) < config.n_wanted
        if restart and (breakdown or stall >= _STALL_CYCLES):
            stall = 0
            # Random restart (restarted_ca_lanczos.m:204-248) from the
            # replicated host generator: the same vector on every rank.
            q_h = rng.standard_normal(n)
            if nconv:
                Qc = Adist.gather_columns(Qconv)[:, :nconv]
                q_h = q_h - Qc @ (Qc.T @ q_h)
            q = Adist.shard_entry(q_h / np.linalg.norm(q_h))
        elif restart:
            strategy = RestartStrategy(config.restart_strategy)
            cand = d[k_est:]
            ok = np.abs(cand) <= 1.05 * norm_A
            if not np.any(ok):
                ok = np.ones(len(cand), bool)
            if len(cand) == 0:
                idx = m - 1
            elif strategy == RestartStrategy.SMALLEST:
                idx = k_est + int(np.argmin(np.where(ok, cand, np.inf)))
            elif strategy == RestartStrategy.CLOSEST_CONV:
                idx = k_est + int(np.argmin(np.where(ok, ritz_norms[k_est:], np.inf)))
            elif strategy == RestartStrategy.RANDOM:
                idx = k_est + int(rng.choice(np.flatnonzero(ok)))
            else:
                idx = k_est + int(np.argmax(np.where(ok, cand, -np.inf)))
            q = _dist_ritz_vector(Q_cycle, Vp[:, idx])
            q = q / local_norm(q, mesh)

        if checkpoint_path is not None:
            from ca_lanczos_tpu_torch.utils.checkpoint import RestartCheckpoint

            Qc = Adist.gather_columns(Qconv)[:, :nconv] if nconv else None
            qg = Adist.gather_columns(q)
            if dist.get_rank() == 0:
                RestartCheckpoint(
                    n_restarts=n_restarts, nconv=nconv, conv_eigs=conv_eigs,
                    conv_rnorms=conv_rnorms, orth_err=orth_err, rnorm_rows=rnorm_rows,
                    Q_conv=Qc, q=qg, Bk=np.asarray(Bk), rng_state=rng.bit_generator.state,
                ).save(checkpoint_path)
            dist.barrier()

    Q_final = Adist.gather_columns(Qconv)[:, :nconv] if nconv else None
    Qc_rows = None if Q_final is None else torch.from_numpy(np.ascontiguousarray(Q_final.T))
    return _finalize(conv_eigs, conv_rnorms, Qc_rows, n_restarts, rnorm_rows, [],
                     config.n_wanted, not restart, strategy=config.restart_strategy)
