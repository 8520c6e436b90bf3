"""s-step Lanczos (Kim & Chronopoulos style) and its propagator variant.

Counterpart of ``ca_lanczos_tpu/solvers/sstep.py`` (reference
sstep_lanczos.m and sstep_lanczos_prop.m).  A different
communication-avoiding formulation than ca_lanczos: per outer iteration
s+1 SpMVs and 2s dot products, then the block-tridiagonal coefficients
from small s x s Gram solves (W\\c, W\\d, W\\b); the Krylov block is NOT
explicitly orthogonalized (monomial-like, numerically fragile by design).

Device work goes through an ``ops`` object (``_LocalOps`` by default) so
that a distributed driver can reuse the host recurrence over row-sharded
operands: ``powers`` is ``matrix_powers_monomial`` (K1, or K2 steps, on a
real DIA operator on the card), ``dots`` one Gram GEMM P^H P of the
(n, s+1) block read once by the host, ``next_p1`` and ``basis_update``
GEMMs, ``norm`` the start vector's 2-norm (a distributed driver's
reduces over the ranks).  Blocks are (n, k) tensors, as the seam's JAX contract has them.
The s x s solves and the index-heavy coefficient assembly are host float64
numpy, copied 1:1 (0-based) from the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers_monomial
from ca_lanczos_tpu_torch.ops.spmv import Operator, spmv


def _dots_2s(P: torch.Tensor) -> np.ndarray:
    """The 2s dot products of sstep_lanczos.m:51-55, 0-based:
    dotP[2i] = <P[i], P[i]>, dotP[2i+1] = <P[i+1], P[i]> for i = 0..s-1,
    read off one Gram product G = P^H P (real parts, float64 host)."""
    s = P.shape[1] - 1
    G = P.conj().T @ P
    out = torch.empty(2 * s, dtype=G.dtype, device=G.device)
    out[0::2] = torch.diagonal(G)[:s]
    out[1::2] = torch.diagonal(G, 1)
    return out.real.cpu().numpy().astype(np.float64)


def _next_p1(H: Operator, Vk: torch.Tensor, Vkm1: torch.Tensor, Es: torch.Tensor,
             Gs: torch.Tensor) -> torch.Tensor:
    """P(:,1) = H V{k}(:,s) - V{k-1} E(:,s) - V{k} G(:,s)
    (sstep_lanczos.m:111)."""
    return spmv(H, Vk[:, -1].contiguous()) - Vkm1 @ Es - Vk @ Gs


def _basis_update(P: torch.Tensor, Vk: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """V{k+1}(:,j) = P(:,j) - V{k} t(:,j), with t(:,1) = 0
    (sstep_lanczos.m:157-160)."""
    return P - Vk @ t


class _LocalOps:
    """Default single-device operations of the s-step recurrence."""

    def __init__(self, H: Operator):
        self.H = H

    def norm(self, r0):
        return float(torch.linalg.norm(r0))

    def powers(self, p1, s):
        return matrix_powers_monomial(self.H, p1, s)

    def dots(self, P):
        return _dots_2s(P)

    def next_p1(self, Vk, Vkm1, Es, Gs):
        return _next_p1(self.H, Vk, Vkm1, Es, Gs)

    def basis_update(self, P, Vk, t):
        return _basis_update(P, Vk, t)


@dataclasses.dataclass
class SstepResult:
    T: np.ndarray  # (s*m, s*m) block tridiagonal
    Q: torch.Tensor  # (n, s*m) basis (NOT orthogonal by construction)
    residual: float = np.nan


def _sstep_core(H: Operator, r0: torch.Tensor, s: int, m: int, ops=None):
    """Shared recurrence of sStepLanczos/sstep_lanczos_prop.

    Returns (V_blocks [m blocks of (n, s)], E, F, G block lists, last P,
    ||r0||).  Block lists are MATLAB-style 1-based (index 0 unused) so the
    reference's cell indexing (E{k-1}, G{k}, F{k}) maps 1:1.

    ``ops`` injects the device operations (norm / powers / dots / next_p1
    / basis_update), so a distributed driver reuses this exact host
    recurrence.
    """
    if ops is None:
        ops = _LocalOps(H)
    nrm = ops.norm(r0)
    p1 = r0 / nrm

    E = [np.zeros((s, s)) for _ in range(m + 2)]
    F = [np.zeros((s, s)) for _ in range(m + 2)]
    G = [np.zeros((s, s)) for _ in range(m + 2)]
    Vb: List[torch.Tensor] = []

    # First monomial block P = [p1, H p1, ..., H^s p1] (sstep_lanczos.m:43-45).
    P = ops.powers(p1, s)
    Vb.append(P[:, :s])

    dotP = np.asarray(ops.dots(P), np.float64)

    # v1av1(i,j) = dotP(i+j-s) when positive (sstep_lanczos.m:59-65); 1-based.
    v1av1 = np.zeros((s, s))
    for j in range(1, s + 1):
        for i in range(1, s + 1):
            if i + j - s > 0:
                v1av1[i - 1, j - 1] = dotP[i + j - s - 1]

    W = np.zeros((s, s))
    t = np.zeros((s, s))
    c = np.zeros((s, s))

    for k in range(2, m + 2):  # MATLAB k = 2..m+1
        # c (sstep_lanczos.m:72-74).
        c[:, :] = 0.0
        c[s - 1, :] = dotP[:s]
        if k > 2:
            for j in range(s):
                E[k - 1][:, j] = np.linalg.solve(W, c[:, j])

        # W (sstep_lanczos.m:82-92).
        Wn = np.zeros((s, s))
        for j in range(1, s + 1):
            for i in range(j, s + 1):
                acc = dotP[i + j - 2]
                r = s + 2 - j
                for l in range(r, s + 1):
                    acc -= t[l - 1, i - 1] * v1av1[l - 1, j - 2]
                Wn[i - 1, j - 1] = acc
                Wn[j - 1, i - 1] = acc
        W = Wn

        # d and G (sstep_lanczos.m:96-108).
        d = np.zeros((s, s))
        for j in range(1, s):
            for i in range(j, s + 1):
                val = W[i - 1, j] - t[s - 1, j - 1] * c[s - 1, i - 1]
                d[i - 1, j - 1] = val
                d[j - 1, i - 1] = val
        acc = dotP[2 * s - 1] - t[s - 1, s - 1] * c[s - 1, s - 1]
        for i in range(1, s + 1):
            acc -= t[i - 1, s - 1] * v1av1[i - 1, s - 1]
        d[s - 1, s - 1] = acc
        for j in range(s):
            G[k][:, j] = np.linalg.solve(W, d[:, j])

        # Next seed vector (sstep_lanczos.m:111) and F quirk (:114 — the
        # reference sets the coupling to 1 rather than the residual norm).
        Vkm1 = Vb[-2] if len(Vb) >= 2 else torch.zeros_like(Vb[-1])
        Es_col = torch.as_tensor(E[k - 1][:, s - 1] if k > 2 else np.zeros(s),
                                 dtype=P.dtype, device=P.device)
        Gs_col = torch.as_tensor(G[k][:, s - 1], dtype=P.dtype, device=P.device)
        p_next = ops.next_p1(Vb[-1], Vkm1, Es_col, Gs_col)
        F[k][0, s - 1] = 1.0

        if k == m + 1:
            return Vb, E, F, G, p_next, nrm

        # New powers block and dot products (sstep_lanczos.m:118-128).
        P = ops.powers(p_next, s)
        dotP = np.asarray(ops.dots(P), np.float64)

        # v1av1 update (sstep_lanczos.m:132-142).  NOTE: deliberately
        # in-place and order-dependent like the reference — entries with
        # i+j-s <= 0 keep their previous-iteration values, and the inner
        # accumulation reads columns updated earlier in this same sweep.
        for j in range(1, s + 1):
            for i in range(1, s + 1):
                if i + j - s > 0:
                    v1av1[i - 1, j - 1] = dotP[i + j - s - 1]
                r = 2 * (s + 1) - (i + j)
                for l in range(r, s + 1):
                    v1av1[i - 1, j - 1] += (
                        G[k][l - 1, s - 1] * v1av1[l - 1, (i + j) - (s + 1) - 1]
                    )

        # b and t (sstep_lanczos.m:146-153).
        b = np.zeros((s, s))
        for j in range(2, s + 1):
            for i in range(s - j + 2, s + 1):
                b[i - 1, j - 1] = v1av1[i - 1, j - 2]
        for j in range(s):
            t[:, j] = np.linalg.solve(W, b[:, j])

        # Basis update (sstep_lanczos.m:156-160): column 1 is p_next.
        t_j = torch.as_tensor(t, dtype=P.dtype, device=P.device)
        Vn = ops.basis_update(P[:, :s], Vb[-1], t_j)
        Vn[:, 0] = p_next
        Vb.append(Vn)

    return Vb, E, F, G, p_next, nrm


def _assemble_T(E, F, G, m: int, s: int) -> np.ndarray:
    """Block tridiagonal assembly (sstep_lanczos.m:165-172): for MATLAB
    k = 1..m, diagonal block G{k+1}; sub F{k+1}, super E{k+1} for k < m.
    Lists are 1-based (see _sstep_core)."""
    T = np.zeros((s * m, s * m))
    for k in range(1, m + 1):
        ix = (k - 1) * s
        T[ix : ix + s, ix : ix + s] = G[k + 1]
        if k < m:
            T[ix + s : ix + 2 * s, ix : ix + s] = F[k + 1]
            T[ix : ix + s, ix + s : ix + 2 * s] = E[k + 1]
    return T


def sstep_lanczos(H: Operator, psi: torch.Tensor, s: int, m: int, ops=None) -> SstepResult:
    """s-step Lanczos eigensolver block factorization
    (sstep_lanczos.m:14-178)."""
    Vb, E, F, G, _, _ = _sstep_core(H, psi, s, m, ops)
    T = _assemble_T(E, F, G, m, s)
    return SstepResult(T=T, Q=torch.cat(Vb[:m], dim=1))


def sstep_lanczos_prop(
    H: Operator, r0: torch.Tensor, s: int, m: int, dt: float, tol: float = 1.0e-10,
    ops=None,
) -> SstepResult:
    """Propagator variant (sstep_lanczos_prop.m:14-189): same recurrence
    plus the exp(-i dt T) residual estimate
    |dt * [expm(-i dt T)]_{sm,1} * ||P1|| * ||r0||| (:118-127).  A real
    r0 is taken as complex128."""
    if not r0.is_complex():
        r0 = r0.to(torch.complex128)
    Vb, E, F, G, p_next, nrm = _sstep_core(H, r0, s, m, ops)
    T = _assemble_T(E, F, G, m, s)
    d, Vp = np.linalg.eig(T)
    matexp = (Vp * np.exp(-1j * dt * d)) @ np.linalg.inv(Vp)
    residual = abs(dt * matexp[s * m - 1, 0] * float(torch.linalg.norm(p_next)) * nrm)
    return SstepResult(T=T, Q=torch.cat(Vb[:m], dim=1), residual=float(residual))
