"""Lanczos time propagators for quantum dynamics: psi(t+dt) ~ Q expm(-i dt T) e1 ||psi||.

Counterpart of ``ca_lanczos_tpu/solvers/propagators.py`` (reference
lanczos_prop.m, ca_lanczos_prop.m and the runLanczos.m experiment: 1-D
harmonic oscillator, N=512, dt=0.025, 200 steps, s=6, 24 Krylov steps,
residual tol 1e-10).

The Hamiltonian is real symmetric, the wavefunction complex.  Two forms:

* complex: complex128 vectors on the operator's device.  A real DIA
  operator applies them by real and imaginary parts through K2 (``spmv``)
  and K1 (``matrix_powers_from_B`` / ``matrix_powers_monomial``), see
  ``ops.cuda_spmv.by_parts``.  Alpha and beta come to the host once per
  Krylov step; the small exponential is host numpy/scipy.
* split: the same recurrence in real arithmetic on a split vector, two
  contiguous real rows [re, im] (a (2, n) tensor), each row sent to the
  kernels on its own (``spmv`` of a 2-D argument stays the plain product).
  Bases are kept as (m, 2, n) rows.  The public results carry the JAX
  package's layout as views of those rows: ``SplitPropResult.Q`` is
  (n, 2, m), ``apply_exp`` returns (n, 2); split inputs are (n, 2) too.
  The propagation loops return the final psi as a complex tensor on the
  operator's device (the JAX package returns numpy for the split loops).

The one-call forms (``propagate_split_fused``) are one XLA program in the
JAX package; here they are torch loops that keep alpha/beta on the device,
take ``torch.linalg.eigh`` of the small T on the device, and rebuild the
basis by re-running the recurrence (no stored Q).  The adaptive one reads
its exit flag on the host once per Krylov step and takes the JAX package's
number of Krylov steps.

The small-T exponential uses the eigendecomposition of a symmetric T
(exact for the standard Lanczos T); the CA T (near-symmetric up to
roundoff) goes through scipy's expm, as expm() in ca_lanczos_prop.m:122.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.linalg
import torch

from ca_lanczos_tpu_torch.basis.leja import leja
from ca_lanczos_tpu_torch.basis.newton import newton_basis_matrix
from ca_lanczos_tpu_torch.config import Basis, LejaVariant, Orth
from ca_lanczos_tpu_torch.ops.csplit import split_cholqr, split_project
from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers_from_B, matrix_powers_monomial
from ca_lanczos_tpu_torch.ops.orth import normalize, project_and_normalize
from ca_lanczos_tpu_torch.ops.spmv import Operator, spmv
from ca_lanczos_tpu_torch.solvers._block import block_T, extend_T, first_block_T
from ca_lanczos_tpu_torch.solvers.ca_lanczos import monomial_basis_matrix
from ca_lanczos_tpu_torch.solvers.lanczos import lanczos


def _complex(psi) -> torch.Tensor:
    """A tensor as complex (complex128 unless already complex)."""
    psi = torch.as_tensor(psi)
    return psi if psi.is_complex() else psi.to(torch.complex128)


@dataclasses.dataclass
class PropResult:
    """Krylov factorization for one propagation step.

    T: real (m, m) projection matrix; Q: (n, m) complex basis (a view of
    row storage); n_steps: Krylov dimension actually built; residual: last
    residual estimate |dt * beta * [expm(-i dt T)]_{m,1} * ||psi|||.
    """

    T: np.ndarray
    Q: torch.Tensor
    n_steps: int
    residual: float

    def apply_exp(self, dt: float, nrm: float) -> torch.Tensor:
        """psi(t+dt) = Q expm(-i dt T) e1 * ||psi|| (runLanczos.m:102)."""
        m = self.T.shape[0]
        E = _expm_tridiag(self.T, dt)
        coeff = torch.as_tensor(E[:m, 0] * nrm, dtype=self.Q.dtype, device=self.Q.device)
        return self.Q @ coeff


def _expm_tridiag(T: np.ndarray, dt: float) -> np.ndarray:
    """expm(-i dt T) for small T (host).  Symmetric T goes through eigh
    (exact); general T through scipy (ca_lanczos_prop.m:122)."""
    T = np.asarray(T, np.float64)
    if np.allclose(T, T.T, atol=1e-12 * max(1.0, np.abs(T).max())):
        d, V = np.linalg.eigh(T)
        return (V * np.exp(-1j * dt * d)) @ V.T
    return scipy.linalg.expm(-1j * dt * T)


def _tridiag(alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    m = len(alpha)
    T = np.diag(alpha)
    if m > 1:
        T += np.diag(beta[: m - 1], 1) + np.diag(beta[: m - 1], -1)
    return T


def _prop_step(H: Operator, qj: torch.Tensor, qjm1: Optional[torch.Tensor], beta_prev: float):
    """One complex Lanczos step (lanczos_prop.m:31-41); (alpha, beta) come
    to the host in one read."""
    r = spmv(H, qj)
    if qjm1 is not None:
        r = r - beta_prev * qjm1
    alpha = torch.vdot(qj, r).real
    r = r - alpha * qj
    beta = torch.linalg.norm(r)
    a, b = torch.stack([alpha, beta]).cpu().tolist()
    return r / beta, a, b


def lanczos_prop(
    H: Operator,
    r0: torch.Tensor,
    maxiter: int,
    dt: float,
    tol: float = 1.0e-10,
    adaptive: bool = False,
) -> PropResult:
    """Krylov approximation of exp(-i dt H) psi (lanczos_prop.m:15-61).

    With ``adaptive`` the iteration stops as soon as the residual
    |dt * beta_j * [expm(-i dt T_j)]_{j,1} * ||psi||| drops below tol
    (lanczos_prop.m:44-55)."""
    r0 = _complex(r0)
    n = r0.shape[0]
    nrm = float(torch.linalg.norm(r0))
    Q = torch.zeros((maxiter + 1, n), dtype=r0.dtype, device=r0.device)  # rows
    Q[0] = r0 / nrm
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)
    residual = np.inf
    j = 0
    for j in range(1, maxiter + 1):
        qjm1 = Q[j - 2] if j > 1 else None
        Q[j], alpha[j - 1], beta[j - 1] = _prop_step(
            H, Q[j - 1], qjm1, beta[j - 2] if j > 1 else 0.0)
        if j >= 3:
            E = _expm_tridiag(_tridiag(alpha[:j], beta[:j]), dt)
            residual = abs(dt * beta[j - 1] * E[j - 1, 0] * nrm)
            if residual < tol and adaptive:
                break
    T = _tridiag(alpha[:j], beta[:j])
    return PropResult(T=T, Q=Q[:j].T, n_steps=j, residual=float(residual))


def _newton_B(A: Operator, q: torch.Tensor, s: int, eigest) -> np.ndarray:
    """The NONmodified Newton basis matrix from nonmodified Leja ordering
    of the real parts of eigest, or of a 2s-step Lanczos bootstrap from q
    when eigest is None (ca_lanczos_prop.m:31-41)."""
    if eigest is None:
        boot = lanczos(A, q, 2 * s, Orth.LOCAL)
        eigest = np.linalg.eigvalsh(boot.T)
    shifts = leja(np.real(np.asarray(eigest)), LejaVariant.NONMODIFIED)
    return newton_basis_matrix(shifts, s, modified=False)


def ca_lanczos_prop(
    A: Operator,
    r0: torch.Tensor,
    s: int,
    m: int,
    dt: float,
    tol: float = 1.0e-10,
    basis: Basis = Basis.NEWTON,
    eigest: Optional[np.ndarray] = None,
    adaptive: bool = False,
) -> PropResult:
    """CA propagator: one block of s SpMVs per orthogonalization round
    (ca_lanczos_prop.m:3-135).

    ``eigest`` supplies basis eigenvalue estimates, skipping the 2s-step
    Lanczos bootstrap (ca_lanczos_prop.m:31-39).  Newton shifts come from
    the single-arg leja path — nonmodified ordering of the real parts
    (ca_lanczos_prop.m:40) — and the NONmodified newton basis matrix
    (modifiedp=0, ca_lanczos_prop.m:41).  Blocks are (s+1, n) rows.
    """
    basis = Basis(basis)
    r0 = _complex(r0)
    nrm = float(torch.linalg.norm(r0))
    q = r0 / nrm
    Bk = monomial_basis_matrix(s) if basis == Basis.MONOMIAL else _newton_B(A, r0, s, eigest)

    blocks: List[torch.Tensor] = []  # each (s+1, n)
    b = np.zeros(m)
    T: Optional[np.ndarray] = None
    residual = np.inf
    k = 0
    while k < m:
        k += 1
        if k > 1:
            q = blocks[-1][s]
        if basis == Basis.MONOMIAL:
            V = matrix_powers_monomial(A, q, s)
        else:
            V = matrix_powers_from_B(A, q, Bk)

        if k == 1:
            Qb, Rk, _ = normalize(V)
            blocks.append(Qb.T)
            T, b[0] = first_block_T(Rk, Bk, s)
        else:
            # No conditional second pass (reorth=False, ca_lanczos_prop.m:78).
            res = project_and_normalize([blocks[-1].T], V[:, 1 : s + 1], reorth=False)
            Tk, b[k - 1], _ = block_T(res.R_blocks[0], res.R, Bk, b[k - 2], s)
            T = extend_T(T, Tk, b[k - 2], b[k - 1], s)
            blocks.append(torch.cat([blocks[-1][s : s + 1], res.Q.T]))

        # Residual from the exponential of the current T
        # (ca_lanczos_prop.m:120-128).
        E = _expm_tridiag(np.real(T[: k * s, : k * s]), dt)
        residual = abs(dt * b[k - 1] * E[k * s - 1, 0] * nrm)
        if residual < tol and k * s >= 3 and adaptive:
            break

    # Assemble the basis (ca_lanczos_prop.m:131-134): block 1 contributes
    # its s+1 vectors, later blocks their s NEW ones (their first is the
    # previous block's last, stored twice); trim to k*s.
    Q = torch.cat([blocks[0]] + [Bq[1:] for Bq in blocks[1:]])[: k * s]
    return PropResult(T=np.real(T[: k * s, : k * s]), Q=Q.T, n_steps=k * s,
                      residual=float(residual))


def propagate(
    H: Operator,
    psi0,
    dt: float,
    n_steps: int,
    krylov_dim: int = 24,
    method: str = "lanczos",
    s: int = 6,
    tol: float = 1.0e-10,
    basis: Basis = Basis.NEWTON,
    eigest: Optional[np.ndarray] = None,
    adaptive: bool = False,
) -> torch.Tensor:
    """Time loop of runLanczos.m:66-131: psi <- Q expm(-i dt T) e1 ||psi||
    per step.  method in {"lanczos", "ca"}.  Returns the final psi."""
    psi = _complex(psi0)
    if method == "ca" and Basis(basis) == Basis.NEWTON and eigest is None:
        boot = lanczos(H, psi, 2 * s, Orth.LOCAL)
        eigest = np.linalg.eigvalsh(boot.T)

    for _ in range(n_steps):
        nrm = float(torch.linalg.norm(psi))
        if method == "lanczos":
            res = lanczos_prop(H, psi, krylov_dim, dt, tol, adaptive)
        elif method == "ca":
            res = ca_lanczos_prop(H, psi, s, krylov_dim // s, dt, tol, basis, eigest, adaptive)
        else:
            raise ValueError(f"unknown method {method}")
        psi = res.apply_exp(dt, nrm)
    return psi


# ---------------------------------------------------------------------------
# Real/imag-split path: the complex wavefunction as two real rows.
#
# The Hamiltonian is real symmetric, so applying it to the rows [re, im]
# IS the complex SpMV, and the Lanczos coefficients are real.  Only the
# final exp(-i dt T) e1 coefficients are complex — applied as a 2x2 real
# rotation per vector.
# ---------------------------------------------------------------------------


def _to_split(psi) -> torch.Tensor:
    """Complex (n,) or split (n, 2) -> split rows (2, n), contiguous."""
    psi = torch.as_tensor(psi)
    if psi.ndim == 2:
        return psi.T.contiguous()
    return torch.stack([psi.real, psi.imag])


def _apply_rows(H: Operator, X: torch.Tensor) -> torch.Tensor:
    """H applied to each row of X (k, n): one ``spmv`` per row, so each
    contiguous row reaches the operator's kernel."""
    return torch.stack([spmv(H, x) for x in X])


def _prop_step_split(H: Operator, qj: torch.Tensor, qjm1: Optional[torch.Tensor],
                     beta_prev: float):
    """One Lanczos step on split rows (2, n): alpha = Re <q, r> =
    sum(q_re r_re + q_im r_im); the Im part vanishes for Hermitian H."""
    r = _apply_rows(H, qj)
    if qjm1 is not None:
        r = r - beta_prev * qjm1
    alpha = torch.sum(qj * r)
    r = r - alpha * qj
    beta = torch.sqrt(torch.sum(r * r))
    a, b = torch.stack([alpha, beta]).cpu().tolist()
    return r / beta, a, b


def _split_rotate(Qr: torch.Tensor, c: np.ndarray) -> torch.Tensor:
    """Rows (2, n) of sum_j Q_j c_j for split basis rows Qr (m, 2, n) and
    complex host coefficients c (m,)."""
    cr = torch.as_tensor(np.real(c), dtype=Qr.dtype, device=Qr.device)
    ci = torch.as_tensor(np.imag(c), dtype=Qr.dtype, device=Qr.device)
    re, im = Qr[:, 0], Qr[:, 1]  # (m, n) each
    return torch.stack([cr @ re - ci @ im, ci @ re + cr @ im])


@dataclasses.dataclass
class SplitPropResult:
    """Krylov factorization with the basis in split (n, 2, m) layout (a
    view of (m, 2, n) rows)."""

    T: np.ndarray
    Q: torch.Tensor  # (n, 2, m)
    n_steps: int
    residual: float

    def apply_exp(self, dt: float, nrm: float) -> torch.Tensor:
        """psi(t+dt) in split (n, 2) layout (a view of two rows)."""
        m = self.T.shape[0]
        E = _expm_tridiag(self.T, dt)
        return _split_rotate(self.Q.permute(2, 1, 0), E[:m, 0] * nrm).T


def lanczos_prop_split(
    H: Operator,
    r0,
    maxiter: int,
    dt: float,
    tol: float = 1.0e-10,
    adaptive: bool = False,
) -> SplitPropResult:
    """lanczos_prop on the split representation — numerically the complex
    path for real symmetric H (lanczos_prop.m:15-61) in real arithmetic."""
    psi = _to_split(r0)
    nrm = float(torch.sqrt(torch.sum(psi * psi)))
    Q = torch.zeros((maxiter + 1,) + tuple(psi.shape), dtype=psi.dtype, device=psi.device)
    Q[0] = psi / nrm
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)
    residual = np.inf
    j = 0
    for j in range(1, maxiter + 1):
        qjm1 = Q[j - 2] if j > 1 else None
        Q[j], alpha[j - 1], beta[j - 1] = _prop_step_split(
            H, Q[j - 1], qjm1, beta[j - 2] if j > 1 else 0.0)
        if j >= 3:
            E = _expm_tridiag(_tridiag(alpha[:j], beta[:j]), dt)
            residual = abs(dt * beta[j - 1] * E[j - 1, 0] * nrm)
            if residual < tol and adaptive:
                break
    T = _tridiag(alpha[:j], beta[:j])
    return SplitPropResult(T=T, Q=Q[:j].permute(2, 1, 0), n_steps=j,
                           residual=float(residual))


def propagate_split(
    H: Operator,
    psi0,
    dt: float,
    n_steps: int,
    krylov_dim: int = 24,
    tol: float = 1.0e-10,
    adaptive: bool = False,
) -> torch.Tensor:
    """Split-representation time loop; returns the final complex psi."""
    psi = _to_split(psi0)
    for _ in range(n_steps):
        nrm = float(torch.sqrt(torch.sum(psi * psi)))
        res = lanczos_prop_split(H, psi.T, krylov_dim, dt, tol, adaptive)
        psi = res.apply_exp(dt, nrm).T
    return torch.complex(psi[0], psi[1])


def _split_powers(H: Operator, q: torch.Tensor, B: np.ndarray) -> torch.Tensor:
    """Matrix powers of split rows q (2, n) for a real change-of-basis
    matrix B: the real Hamiltonian acts on each row alone
    (``matrix_powers_from_B`` per row: K1, or K2 steps, on a DIA
    operator).  Returns rows (s+1, 2, n)."""
    return torch.stack([matrix_powers_from_B(H, q[0], B).T,
                        matrix_powers_from_B(H, q[1], B).T], dim=1)


def ca_lanczos_prop_split(
    A: Operator,
    r0,
    s: int,
    m: int,
    dt: float,
    tol: float = 1.0e-10,
    basis: Basis = Basis.NEWTON,
    eigest: Optional[np.ndarray] = None,
    adaptive: bool = False,
) -> SplitPropResult:
    """ca_lanczos_prop on the real/imag-split representation.

    Identical block structure (ca_lanczos_prop.m:49-129) with the block
    orthogonalization decomposed into real Gram/update products
    (``ops.csplit``); the Newton shifts are real (nonmodified Leja of the
    real Ritz estimates, ca_lanczos_prop.m:40), so the recurrence
    coefficients stay real.  The bootstrap runs on the real row of q.
    """
    basis = Basis(basis)
    psi = _to_split(r0)
    nrm = float(torch.sqrt(torch.sum(psi * psi)))
    q = psi / nrm
    Bk = (monomial_basis_matrix(s) if basis == Basis.MONOMIAL
          else _newton_B(A, q[0].clone(), s, eigest))
    Br = np.real(Bk)

    blocks: List[torch.Tensor] = []  # rows, each (s+1, 2, n)
    b = np.zeros(m)
    T: Optional[np.ndarray] = None
    residual = np.inf
    k = 0
    while k < m:
        k += 1
        if k > 1:
            q = blocks[-1][s]
        V = _split_powers(A, q, Br).permute(2, 1, 0)  # (n, 2, s+1)

        if k == 1:
            Qb, Rk = split_cholqr(V)
            blocks.append(Qb.permute(2, 1, 0))
            T, b[0] = first_block_T(Rk, Bk, s)
        else:
            Y, Rkk = split_project(blocks[-1].permute(2, 1, 0), V[:, :, 1 : s + 1], passes=1)
            Qn, R = split_cholqr(Y)
            Tk, b[k - 1], _ = block_T(Rkk, R, Bk, b[k - 2], s)
            T = extend_T(T, Tk, b[k - 2], b[k - 1], s)
            blocks.append(torch.cat([blocks[-1][s : s + 1], Qn.permute(2, 1, 0)]))

        E = _expm_tridiag(np.real(T[: k * s, : k * s]), dt)
        residual = abs(dt * b[k - 1] * E[k * s - 1, 0] * nrm)
        if residual < tol and k * s >= 3 and adaptive:
            break

    Q = torch.cat([blocks[0]] + [Bq[1:] for Bq in blocks[1:]])[: k * s]
    return SplitPropResult(T=np.real(T[: k * s, : k * s]), Q=Q.permute(2, 1, 0),
                           n_steps=k * s, residual=float(residual))


# ---------------------------------------------------------------------------
# One-call forms: alpha/beta stay on the device, no stored basis.
# ---------------------------------------------------------------------------


def _lanczos_next(H: Operator, q_prev, q, b_prev, a, b):
    """The next split Lanczos vector from (q_prev, q) with alpha a and beta
    b known: (H q - b_prev q_prev - a q) / b, or zero at an exact happy
    breakdown (b == 0, a zero vector then propagates harmlessly: T
    decouples, its e1 coupling is 0)."""
    r = _apply_rows(H, q) - b_prev * q_prev - a * q
    return torch.where(b > 0, r / torch.where(b > 0, b, 1.0), 0.0)


def _split_step(H: Operator, q_prev, q, b_prev):
    """One split Lanczos step kept on the device: (q_next, alpha, beta)."""
    r = _apply_rows(H, q) - b_prev * q_prev
    a = torch.sum(q * r)
    r = r - a * q
    b = torch.sqrt(torch.sum(r * r))
    return torch.where(b > 0, r / torch.where(b > 0, b, 1.0), 0.0), a, b


def _tridiag_dev(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return torch.diag(alpha) + torch.diag(beta[:-1], 1) + torch.diag(beta[:-1], -1)


def _exp_weights(alpha: torch.Tensor, beta: torch.Tensor, dt: float, nrm: torch.Tensor):
    """(cr, ci): real and imaginary parts of V exp(-i dt d) V^T e1 * nrm
    for T = tridiag(alpha, beta) (eigh on the device)."""
    d, V = torch.linalg.eigh(_tridiag_dev(alpha, beta))
    ve1 = V[0, :] * nrm
    return V @ (torch.cos(dt * d) * ve1), V @ (-torch.sin(dt * d) * ve1)


def _rebuild(H: Operator, q0, alpha, beta, cr, ci) -> torch.Tensor:
    """sum_j q_j (cr_j + i ci_j) in split rows, re-running the recurrence
    from q0 with the known alpha/beta (two passes instead of storing the
    n x m basis)."""
    acc = torch.zeros_like(q0)
    q_prev, q, b_prev = torch.zeros_like(q0), q0, 0.0
    for j in range(alpha.shape[0]):
        acc[0] += q[0] * cr[j] - q[1] * ci[j]
        acc[1] += q[0] * ci[j] + q[1] * cr[j]
        if j + 1 < alpha.shape[0]:
            q_prev, q, b_prev = q, _lanczos_next(H, q_prev, q, b_prev, alpha[j], beta[j]), beta[j]
    return acc


def _fused_time_step(H: Operator, psi: torch.Tensor, dt: float, m: int) -> torch.Tensor:
    """One time step of fixed Krylov dimension m on split rows (2, n)."""
    nrm = torch.sqrt(torch.sum(psi * psi))
    q0 = psi / nrm
    alpha = torch.zeros(m, dtype=psi.dtype, device=psi.device)
    beta = torch.zeros_like(alpha)
    q_prev, q = torch.zeros_like(q0), q0
    for j in range(m):
        q_next, alpha[j], beta[j] = _split_step(H, q_prev, q, beta[j - 1] if j else 0.0)
        q_prev, q = q, q_next
    cr, ci = _exp_weights(alpha, beta, dt, nrm)
    return _rebuild(H, q0, alpha, beta, cr, ci)


def _residual_dev(alpha: torch.Tensor, beta: torch.Tensor, dt: float, nrm: torch.Tensor
                  ) -> torch.Tensor:
    """|dt * beta_j * [exp(-i dt T_j)]_{j,1}| * nrm for T_j of the first
    j = len(alpha) steps (lanczos_prop.m:44-55), on the device."""
    d, V = torch.linalg.eigh(_tridiag_dev(alpha, beta))
    w = V[-1, :] * V[0, :]
    er, ei = torch.sum(w * torch.cos(dt * d)), torch.sum(w * torch.sin(dt * d))
    return abs(dt) * beta[-1] * torch.sqrt(er * er + ei * ei) * nrm


def _adaptive_time_step(H: Operator, psi: torch.Tensor, dt: float, m: int, tol: float):
    """One time step that stops its Krylov expansion at the first j >= 3
    with residual < tol (the exit flag read on the host once per step).
    Returns (psi rows, j_used)."""
    nrm = torch.sqrt(torch.sum(psi * psi))
    q0 = psi / nrm
    alpha = torch.zeros(m, dtype=psi.dtype, device=psi.device)
    beta = torch.zeros_like(alpha)
    q_prev, q = torch.zeros_like(q0), q0
    j = 0
    while j < m:
        q_next, alpha[j], beta[j] = _split_step(H, q_prev, q, beta[j - 1] if j else 0.0)
        q_prev, q = q, q_next
        j += 1
        if j >= 3 and bool(_residual_dev(alpha[:j], beta[:j], dt, nrm) < tol):
            break
    cr, ci = _exp_weights(alpha[:j], beta[:j], dt, nrm)
    return _rebuild(H, q0, alpha[:j], beta[:j], cr, ci), j


def propagate_split_fused(
    H: Operator, psi0, dt: float, n_steps: int, krylov_dim: int = 24,
    adaptive: bool = False, tol: float = 1.0e-10,
) -> torch.Tensor:
    """The one-call propagation (module docstring); returns the final
    complex psi.  ``adaptive=True`` stops each time step's Krylov expansion
    at the first j with residual < tol (lanczos_prop.m:44-55)."""
    if adaptive:
        return propagate_split_fused_steps(H, psi0, dt, n_steps, krylov_dim, tol)[0]
    psi = _to_split(psi0)
    for _ in range(n_steps):
        psi = _fused_time_step(H, psi, dt, krylov_dim)
    return torch.complex(psi[0], psi[1])


def propagate_split_fused_steps(
    H: Operator, psi0, dt: float, n_steps: int, krylov_dim: int = 24,
    tol: float = 1.0e-10,
):
    """Adaptive one-call propagation returning (psi, total Krylov steps),
    the count the parity checks hold against the host adaptive path."""
    psi = _to_split(psi0)
    total = 0
    for _ in range(n_steps):
        psi, j = _adaptive_time_step(H, psi, dt, krylov_dim, tol)
        total += j
    return torch.complex(psi[0], psi[1]), total
