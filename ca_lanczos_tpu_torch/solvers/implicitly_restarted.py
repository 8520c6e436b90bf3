"""Implicitly-restarted (CA-)Lanczos with exact-shift QR steps.

Counterpart of ``ca_lanczos_tpu/solvers/implicitly_restarted.py``
(reference: impl_restarted_ca_lanczos.m, a Sorensen-style IRL; qrstep at
:623-678 is the D.C. Sorensen 2000 bulge chase).  The reference file is
partially finished (CA inner commented out at :87-94, deflation disabled
at :116-152, the per-restart coupling overwrites the true beta_k with 1);
like the JAX package, this module implements the *intended* design:

* Krylov factorization A V_m = V_m T_m + r e_m^T extended from k to
  m = k + p columns by the standard three-term recurrence, full-orth
  Arnoldi, or the CA matrix-powers inner iteration (K1 on a real DIA
  operator on the card);
* the p unwanted Ritz values applied as exact single shifts via QR
  bulge-chase sweeps (qrstep semantics, all-real for symmetric A);
* the Arnoldi-style residual update
  r+ = V_m Q e_{k+1} T+(k+1,k) + r Q(m,k) (:110-114);
* convergence of the k-window Ritz pairs via beta_k |y_i(k)| < tol
  with tol scaled by normest(A) (:37-41), with locking and purging.

``qrstep`` and ``_retridiagonalize`` are host numpy, copied from the JAX
package.  The basis V is one (m+1, n) tensor of rows, written in place:
each restart compresses the window into a second preallocated buffer W
(rows = small coefficient matrix @ V) and copies the new window back, where
the JAX package builds a fresh (n, m+1) basis every restart.  Rows past
the live window keep stale values; nothing reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.basis.leja import leja
from ca_lanczos_tpu_torch.basis.newton import newton_basis_matrix
from ca_lanczos_tpu_torch.config import Basis, LejaVariant, Orth, OrthParams
from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers
from ca_lanczos_tpu_torch.ops.orth import normalize, project, project_and_normalize
from ca_lanczos_tpu_torch.ops.spmv import Operator, normest, spmv
from ca_lanczos_tpu_torch.solvers._block import block_T, first_block_T
from ca_lanczos_tpu_torch.solvers.ca_lanczos import build_basis_matrix
from ca_lanczos_tpu_torch.utils.spans import span


def qrstep(V: np.ndarray, H: np.ndarray, mu: complex, k1: int, k2: int):
    """One implicit QR restart step (impl_restarted_ca_lanczos.m:623-678).

    0-based window [k1, k2); applies a single real shift or a double
    complex-conjugate shift to the Hessenberg H, accumulating the
    orthogonal transform into V.  Rounding noise below the first
    subdiagonal is zeroed (:673-675).
    """
    kr = slice(k1, k2)
    k = k2 - k1
    eta = np.imag(mu)
    if abs(eta) > 0:
        xi = np.real(mu)
        M = (H[kr, kr] - xi * np.eye(k)) @ (H[kr, kr] - xi * np.eye(k)) + eta**2 * np.eye(k)
        Q, _ = np.linalg.qr(M)
    else:
        Q, _ = np.linalg.qr(H[kr, kr] - np.real(mu) * np.eye(k))
    H[kr, :] = Q.T @ H[kr, :]
    H[:, kr] = H[:, kr] @ Q
    V[:, kr] = V[:, kr] @ Q
    m = H.shape[0]
    for j in range(k1, k2):
        if j + 2 < m:
            H[j + 2 :, j] = 0.0
    return V, H


@dataclasses.dataclass
class IRLResult:
    eigs: np.ndarray
    Q_conv: Optional[torch.Tensor]  # (n, k)
    n_restarts: int
    conv_rnorms: np.ndarray
    converged: bool
    n_locked: int = 0
    n_purged: int = 0


def _retridiagonalize(d: np.ndarray, w: np.ndarray):
    """Reduce the thick-restart arrowhead back to Lanczos form.

    Given the active window in eigencoordinates — A (V Y) = (V Y) diag(d)
    + r (beta w^T) — produce orthogonal U with U[:, -1] = w/|w| and
    U^T diag(d) U tridiagonal, so the compressed window is again a valid
    Lanczos factorization with the residual coupled to the LAST column.
    This is the role of the reference's Hessred (impl_restarted_ca_
    lanczos.m:535-556), done as a fully-reorthogonalized dense Lanczos on
    diag(d) seeded with w (O(ka^2) host work), then column-flipped.

    Returns (U, Ttri) with Ttri = U^T diag(d) U.
    """
    ka = len(d)
    U = np.zeros((ka, ka))
    alpha = np.zeros(ka)
    beta = np.zeros(ka)
    v = w / np.linalg.norm(w)
    U[:, 0] = v
    for j in range(ka):
        r = d * U[:, j]
        if j > 0:
            r = r - beta[j - 1] * U[:, j - 1]
        alpha[j] = U[:, j] @ r
        r = r - alpha[j] * U[:, j]
        r = r - U[:, : j + 1] @ (U[:, : j + 1].T @ r)  # full reorth
        if j + 1 < ka:
            beta[j] = np.linalg.norm(r)
            if beta[j] < 1e-14 * max(np.max(np.abs(d)), 1.0):
                # Invariant subspace hit: restart with a random orthogonal
                # complement direction (harmless — coupling stays exact).
                r = np.random.default_rng(j).standard_normal(ka)
                r = r - U[:, : j + 1] @ (U[:, : j + 1].T @ r)
                beta[j] = 0.0
                r = r / np.linalg.norm(r)
                U[:, j + 1] = r
            else:
                U[:, j + 1] = r / beta[j]
    Ttri = np.diag(alpha) + np.diag(beta[: ka - 1], 1) + np.diag(beta[: ka - 1], -1)
    # Flip so the residual couples to the last column.
    U = U[:, ::-1]
    Ttri = Ttri[::-1, ::-1]
    return U, Ttri


def _std_extend(
    A: Operator,
    V: torch.Tensor,
    T: np.ndarray,
    k0: int,
    m: int,
    orth: Orth,
) -> Tuple[np.ndarray, float]:
    """Extend A V_k = V_k T_k + beta_k v_{k+1} e_k^T to m vectors with the
    standard recurrence (std_lanczos_basic :273-331, with the coupling
    beta_k preserved rather than overwritten by 1).

    V (rows) holds k0+1 live vectors (the +1 is the normalized residual
    direction) and receives rows k0+1..m in place; returns (T ((m+1), m)
    extended, beta_m)."""
    bcgs2 = OrthParams(reference_second_pass=False)
    beta_prev = T[k0, k0 - 1] if k0 > 0 else 0.0
    for j in range(k0, m):
        r = spmv(A, V[j])
        if j > 0:
            r = r - beta_prev * V[j - 1]
        alpha = float(torch.vdot(V[j], r).real)
        r = r - alpha * V[j]
        if orth == Orth.FULL:
            # Cleanup pass against the whole basis with the conventional
            # BCGS2 trigger — the IRL restart compresses the basis, so
            # orthogonality must stay at machine level for the bulge
            # chase to remain a similarity on the factorization.
            r, _ = project([V[: j + 1].T], r, reorth=True, params=bcgs2)
        beta = float(torch.linalg.norm(r))
        T[j, j] = alpha
        T[j + 1, j] = beta
        if j + 1 < T.shape[1]:
            T[j, j + 1] = beta
        V[j + 1] = r / beta
        beta_prev = beta
    return T, float(T[m, m - 1])


def _arnoldi_extend(
    A: Operator,
    V: torch.Tensor,
    T: np.ndarray,
    k0: int,
    m: int,
) -> Tuple[np.ndarray, float]:
    """Arnoldi inner iteration — the reference's sketched alternative
    (commented calls at impl_restarted_ca_lanczos.m:89,94): full-
    orthogonalization Hessenberg extension via solvers.arnoldi.  For
    symmetric A the Hessenberg is tridiagonal to rounding, so the
    symmetric bulge-chase restart machinery stays valid; T is rebuilt
    from the Hessenberg's tridiagonal band (the dropped upper triangle is
    O(eps*||A||)).  Orthogonalization is full by construction
    (arnoldi.m:3-44), so no ``orth`` knob applies."""
    from ca_lanczos_tpu_torch.solvers.arnoldi import arnoldi

    H = np.zeros((m + 1, m), np.float64)
    H[: k0 + 1, :k0] = T[: k0 + 1, :k0]
    # reorth: the IRL compression concentrates the basis on the hardest
    # directions; a single classical GS pass per step loses orthogonality
    # there (same reason _std_extend runs a cleanup pass for orth=full)
    Qf, Hf = arnoldi(A, V[0], m, Q=V.T, H=H, prevvecs=k0, reorth=True)
    V[: m + 1] = Qf.T
    for j in range(k0, m):
        T[j, j] = Hf[j, j].real
        T[j + 1, j] = Hf[j + 1, j].real
        if j + 1 < T.shape[1]:
            T[j, j + 1] = Hf[j + 1, j].real  # symmetrized band
    return T, float(T[m, m - 1])


def _ca_extend(
    A: Operator,
    V: torch.Tensor,
    T: np.ndarray,
    k0: int,
    m: int,
    s: int,
    Bk: np.ndarray,
    basis: Basis,
    orth: Orth,
) -> Tuple[np.ndarray, float]:
    """CA inner iteration (the commented-out intended path,
    impl_restarted_ca_lanczos.m:87,92 -> lanczos_basic :332-426): extend
    by (m - k0) / s matrix-powers blocks, orthogonalizing each against the
    trailing s+1 vectors (plus the full history for orth=full)."""
    if (m - k0) % s:
        raise ValueError(f"the extension {k0}..{m} does not tile into blocks of s={s}")
    b_prev = T[k0, k0 - 1] if k0 > 0 else 0.0
    nvecs = k0
    while nvecs <= m - s:
        Vp = matrix_powers(A, V[nvecs], s, Bk, basis)
        if nvecs == 0:
            with span("solve.orth"):
                Qb, Rk, _ = normalize(Vp)
            V[: s + 1] = Qb.T
            Tk, b_new = first_block_T(Rk, Bk, s)
            T[: s + 1, :s] = Tk
            b_prev = b_new
        else:
            blocks = [V[nvecs - s : nvecs + 1].T]
            if orth == Orth.FULL and nvecs > s:
                blocks = [V[: nvecs - s].T] + blocks
            # reorth=True: the restart compresses the basis onto the hardest
            # directions, so a single CGS pass is not enough — the explicit
            # driver reorthogonalizes everywhere for the same reason.
            with span("solve.orth"):
                res = project_and_normalize(blocks, Vp[:, 1 : s + 1], reorth=True)
            V[nvecs + 1 : nvecs + s + 1] = res.Q.T
            Tk, b_new, _ = block_T(res.R_blocks[-1], res.R, Bk, b_prev, s)
            T[nvecs : nvecs + s, nvecs : nvecs + s] = Tk
            T[nvecs, nvecs - 1] = b_prev
            T[nvecs - 1, nvecs] = b_prev
            T[nvecs + s, nvecs + s - 1] = b_new
            if nvecs + s < T.shape[1]:
                T[nvecs + s - 1, nvecs + s] = 0.0
            b_prev = b_new
        nvecs += s
    return T, float(T[m, m - 1])


def impl_restarted_ca_lanczos(
    A: Operator,
    r: torch.Tensor,
    max_lanczos: int,
    n_wanted: int = 10,
    s: int = 6,
    basis: Basis = Basis.NEWTON,
    orth: Orth = Orth.LOCAL,
    tol: float = 1.0e-6,
    max_restarts: int = 40,
    inner: str = "ca",
    lock: bool = True,
    verify_locked: bool = True,
) -> IRLResult:
    """Implicitly-restarted CA-Lanczos (impl_restarted_ca_lanczos.m:4-228).

    k = n_wanted + 4 retained directions per restart (:74); p unwanted
    Ritz values applied as exact shifts; ``inner`` in {"ca", "std",
    "arnoldi"} picks the expansion iteration ("arnoldi" is the
    reference's sketched alternative, impl_restarted_ca_lanczos.m:89,94).

    ``lock=True`` implements the deflation the reference left as TODO
    (impl_restarted_ca_lanczos.m:116-152): converged wanted Ritz pairs
    are locked into a decoupled leading diagonal block — the bulge chase
    then runs on the window [nlock, m) only (the ``qrstep(.., nconv, m)``
    hook) — and converged UNWANTED pairs are purged from the basis so
    they can never be applied as (numerically singular) exact shifts.
    After each lock/purge the active window is returned to Lanczos form
    by ``_retridiagonalize``.
    """
    basis = Basis(basis)
    orth = Orth(orth)
    norm_A = normest(A)
    tol = tol * norm_A

    n = r.shape[0]
    q = r / torch.linalg.norm(r)
    dtype, dev = q.dtype, q.device

    def small(M) -> torch.Tensor:
        """A host coefficient matrix/vector as a tensor beside V."""
        return torch.as_tensor(np.ascontiguousarray(M), dtype=dtype, device=dev)

    k = n_wanted + 4
    p = s * ((max_lanczos - k) // s)
    m = k + p
    if p <= 0:
        raise ValueError(f"max_lanczos={max_lanczos} too small for k={k} + s={s}")
    if inner == "ca" and k % s != 0:
        # CA blocks must tile the restart window (:68-72 warns; we round
        # k up to the next multiple of s instead of bailing).
        k = s * (-(-k // s))
        p = s * ((max_lanczos - k) // s)
        m = k + p
        if p <= 0:
            raise ValueError("max_lanczos too small after rounding k to a multiple of s")

    Bk = build_basis_matrix(A, q, s, basis, bootstrap_orth=Orth.FULL)

    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)  # the basis, as rows
    V[0] = q
    W = torch.empty((k, n), dtype=dtype, device=dev)  # the compressed window (<= k rows)
    T = np.zeros((m + 1, m))

    n_restarts = 0
    converged = False
    nlock = 0  # decoupled leading diagonal block of locked eigenvalues
    n_purged = 0
    d_locked: list = []
    rnorm_locked: list = []
    ka = 0  # active (compressed, unlocked) vectors carried across restarts
    while n_restarts < max_restarts:
        with span("solve.cycle", n_restarts + 1):
            n_restarts += 1
            j0 = nlock + ka if n_restarts > 1 else 0
            # Extension length must tile into CA blocks; m_eff <= m.
            m_eff = j0 + s * ((m - j0) // s) if inner == "ca" else m
            if m_eff - j0 < (s if inner == "ca" else 1):
                break  # window exhausted (all locked/purged)
            if inner == "ca":
                T, beta_m = _ca_extend(A, V, T, j0, m_eff, s, Bk, basis, orth)
            elif inner == "arnoldi":
                T, beta_m = _arnoldi_extend(A, V, T, j0, m_eff)
            else:
                T, beta_m = _std_extend(A, V, T, j0, m_eff, orth)

            # Shift selection (:97, selectShifts :246-253) on the ACTIVE
            # window [nlock, m_eff): unwanted = smallest (wanted 'largest').
            ka_target = min(k - nlock, m_eff - nlock - 1)
            Ta = T[nlock:m_eff, nlock:m_eff].copy()
            theta = np.linalg.eigvalsh((Ta + Ta.T) / 2)  # ascending
            p_eff = m_eff - nlock - ka_target
            shifts = theta[:p_eff]

            # Residual vector before restart.
            r_vec = beta_m * V[m_eff]

            # Bulge-chase sweep on the unlocked window only — the reference's
            # intended qrstep(Q, Tm, mu, nconv+1, m) hook (:99-108, TODO
            # :116-125); the locked diagonal block is untouched.
            Q = np.eye(m_eff)
            H = T[:m_eff, :m_eff].copy()
            for mu in shifts:
                Q, H = qrstep(Q, H, mu, nlock, m_eff)

            # Truncate the active window to ka_target vectors (:110-114):
            # Vk_new = V[:m_eff] Q[:, nlock:kc], kept as the rows of W.
            kc = nlock + ka_target
            Vk_new = W[:ka_target]
            torch.mm(small(Q[:, nlock:kc].T), V[:m_eff], out=Vk_new)
            r_new = (small(Q[:, kc] * H[kc, kc - 1]) @ V[:m_eff]
                     + r_vec * float(Q[m_eff - 1, kc - 1]))
            beta_k = float(torch.linalg.norm(r_new))
            Ha = (H[nlock:kc, nlock:kc] + H[nlock:kc, nlock:kc].T) / 2

            # Convergence / locking / purging on the compressed active window.
            d, Y = np.linalg.eigh(Ha)  # ascending
            rnorms = beta_k * np.abs(Y[-1, :])
            conv = rnorms < tol
            # Values outside the spectral interval are artifacts of basis
            # breakdown whose residual ESTIMATE can be spuriously tiny (same
            # guard as restarted._lock_converged).
            conv &= np.abs(d) <= 1.05 * norm_A
            n_want_left = n_wanted - nlock
            order_desc = np.argsort(d)[::-1]
            lock_idx = []
            if lock:
                # Lock converged pairs among the wanted (largest) — greedily
                # from the top so locked pairs are the extreme ones.  Each
                # candidate's TRUE residual is sanity-checked first (one SpMV;
                # loose 1%-of-|A| threshold, like the restarted driver): past
                # in-cycle breakdown T decouples and beta_k*|y(end)| lies.
                for i in order_desc[:n_want_left]:
                    if not conv[i]:
                        continue
                    if verify_locked:
                        x = small(Y[:, i]) @ Vk_new
                        true_abs = float(torch.linalg.norm(spmv(A, x) - float(d[i]) * x))
                        if true_abs > 0.01 * norm_A:
                            continue
                    lock_idx.append(i)
                # Purge converged pairs among the unwanted: an exact shift at
                # a converged Ritz value is numerically singular, so drop the
                # direction from the basis entirely.
                purge_idx = [i for i in order_desc[n_want_left:] if conv[i]]
            else:
                purge_idx = []
                if int(np.sum(conv[order_desc[:n_want_left]])) >= n_want_left:
                    converged = True
            keep = [i for i in range(len(d)) if i not in lock_idx and i not in purge_idx]

            if lock and (lock_idx or purge_idx):
                # Transform to eigencoordinates: locked block first, then the
                # re-tridiagonalized remainder (Hessred role, :535-556).
                d_locked.extend(d[lock_idx])
                rnorm_locked.extend(rnorms[lock_idx])
                n_purged += len(purge_idx)
                ka = len(keep)
                C_act = None  # coefficients of the active vectors in Vk_new
                beta_eff = 0.0
                Ttri = np.zeros((0, 0))
                if ka > 0:
                    d_rest = d[keep]
                    w = Y[-1, keep]
                    wn = np.linalg.norm(w)
                    if wn > 0:
                        U, Ttri = _retridiagonalize(d_rest, w)
                        C_act = Y[:, keep] @ U
                        beta_eff = beta_k * wn
                    else:  # residual fully in locked/purged directions
                        Ttri = np.diag(d_rest)
                        C_act = Y[:, keep]
                nlock_new = nlock + len(lock_idx)
                T = np.zeros((m + 1, m))
                for i, dv in enumerate(d_locked):
                    T[i, i] = dv
                T[nlock_new : nlock_new + ka, nlock_new : nlock_new + ka] = Ttri
                if lock_idx:
                    V[nlock:nlock_new] = small(Y[:, lock_idx].T) @ Vk_new
                nlock = nlock_new
                if ka > 0:
                    V[nlock : nlock + ka] = small(C_act.T) @ Vk_new
                    T[nlock + ka, nlock + ka - 1] = beta_eff
                    T[nlock + ka - 1, nlock + ka] = beta_eff
                V[nlock + ka] = r_new / beta_k
                if nlock >= n_wanted:
                    converged = True
                    break
            else:
                # No structural change: keep the chased tridiagonal window
                # as-is (identical to the lock=False legacy restart).
                ka = ka_target
                T = np.zeros((m + 1, m))
                for i, dv in enumerate(d_locked):
                    T[i, i] = dv
                T[kc, kc - 1] = beta_k
                T[kc - 1, kc] = beta_k
                V[nlock:kc] = Vk_new
                V[kc] = r_new / beta_k
                # Ha here is the eigh-symmetrized chased block, which is
                # tridiagonal to roundoff; restore exact tridiagonality.
                T[nlock:kc, nlock:kc] = (
                    np.diag(np.diag(Ha))
                    + np.diag(np.diag(Ha, 1), 1)
                    + np.diag(np.diag(Ha, -1), -1)
                )
                if converged:
                    break

            # Refresh the Newton shifts from the ACTIVE window's Ritz values.
            # The bootstrap shifts sit at the extreme eigenvalues — exactly the
            # pairs locking deflates — so (A - lambda I) nearly annihilates the
            # deflated start vector's dominant components and the powers block
            # is born badly conditioned.  Tracking the unlocked spectrum keeps
            # the s-step basis conditioned; Bk only enters through the NEXT
            # extension's matrix_powers + block_T pair, so a per-restart
            # refresh is exact.  (The reference fixes Bk once at :60/:231-243,
            # but never executed its CA inner — the commented calls at :87,:92
            # — so it never faced locking + Newton together.)
            if basis == Basis.NEWTON and inner == "ca":
                d_act = d[keep] if keep else d
                if len(d_act) >= s:
                    try:
                        Bk = newton_basis_matrix(
                            leja(np.asarray(d_act), LejaVariant.REAL), s, modified=True
                        )
                    except ValueError:
                        pass  # degenerate active spectrum: keep the old shifts

    # Final Ritz extraction: locked pairs + best remaining active pairs.
    kc = nlock + ka
    Ta = (T[nlock:kc, nlock:kc] + T[nlock:kc, nlock:kc].T) / 2
    if Ta.shape[0] > 0:
        d_a, Y_a = np.linalg.eigh(Ta)
        beta_c = float(T[kc, kc - 1]) if kc > 0 else 0.0
        rn_a = beta_c * np.abs(Y_a[-1, :])
    else:
        d_a = np.zeros(0)
        Y_a = np.zeros((0, 0))
        rn_a = np.zeros(0)
    all_d = np.concatenate([np.asarray(d_locked), d_a])
    all_rn = np.concatenate([np.asarray(rnorm_locked), rn_a])
    order = np.argsort(all_d)[::-1][:n_wanted]
    eigs = all_d[order]
    rnorms_out = all_rn[order]
    cols = []
    for i in order:
        if i < nlock:
            cols.append(V[i])
        else:
            cols.append(small(Y_a[:, i - nlock]) @ V[nlock:kc])
    Q_conv = torch.stack(cols, dim=1) if cols else None
    return IRLResult(
        eigs=eigs,
        Q_conv=Q_conv,
        n_restarts=n_restarts,
        conv_rnorms=rnorms_out,
        converged=converged,
        n_locked=nlock,
        n_purged=n_purged,
    )
