"""Matrix-powers kernels: build [q, Aq, ..., A^s q] in one shot.

Counterpart of ``ca_lanczos_tpu/ops/matrix_powers.py``.  All variants are
one generic three-term recurrence driven by the change-of-basis matrix B
(basis/newton.py): since A V_s = V_{s+1} B with B[k+1,k] = 1,

    V[:,k+1] = A V[:,k] - B[k,k] V[:,k] - B[k-1,k] V[:,k-1].

The recurrence is a Python loop over ``spmv``; on CUDA the dispatcher
routes real DIA operators to the hand-written kernels (K1, or K2 when
K1's halo does not fit), the interleaved carrier to K3 and a PELL
operator to K4/K5 (s launches, each fusing its step's shifts).  Divergence
from the TPU package: its ``_pallas_eligible`` also required float32, a
non-CPU backend and a 1024-aligned n — Mosaic limits that do not exist
here — so on CUDA a float64 DIA operator runs K1 where the TPU ran the
XLA scan.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.config import Basis
from ca_lanczos_tpu_torch.ops.spmv import Operator, spmv


def matrix_powers_monomial(A: Operator, q: torch.Tensor, s: int) -> torch.Tensor:
    """V = [q, Aq, A^2 q, ..., A^s q] with shape (n, s+1)."""
    ws = [q]
    for _ in range(s):
        ws.append(spmv(A, ws[-1]))
    return torch.stack(ws, dim=1)


def _newton_scan(A: Operator, q: torch.Tensor, s: int, diag: torch.Tensor,
                 sub: torch.Tensor) -> torch.Tensor:
    """V[:,k+1] = A V[:,k] - diag[k] V[:,k] - sub[k] V[:,k-1], k = 0..s-1."""
    v_km1 = torch.zeros_like(q)
    v_k = q
    ws = [q]
    for k in range(s):
        w = spmv(A, v_k) - diag[k] * v_k - sub[k] * v_km1
        ws.append(w)
        v_km1, v_k = v_k, w
    return torch.stack(ws, dim=1)


def _complex_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.complex128 if dt in (torch.float64, torch.complex128) else torch.complex64


def matrix_powers_newton(A: Operator, q: torch.Tensor, s: int, shifts,
                         modified: bool = False) -> torch.Tensor:
    """Newton-basis matrix powers (reference: matrix_powers_newton.m:15-54).

    With ``modified=True`` conjugate-pair shifts use the real three-term
    recurrence (the +imag^2 correction), so the basis stays real."""
    shifts = np.asarray(shifts)[:s]
    if modified:
        diag = np.real(shifts)
        sub = np.zeros(s, dtype=np.float64)
        for k in range(s):
            im = np.imag(shifts[k])
            if im < 0:
                if k == 0:
                    raise ValueError(
                        "modified Newton: first shift has negative imaginary part"
                        " (matrix_powers_newton.m:36-39)"
                    )
                sub[k] = -(im ** 2)
        dt = q.dtype
        diag_t = torch.as_tensor(diag, dtype=dt, device=q.device)
        sub_t = torch.as_tensor(sub, dtype=dt, device=q.device)
    else:
        dt = _complex_dtype(q.dtype) if np.iscomplexobj(shifts) else q.dtype
        q = q.to(dt)
        diag_t = torch.as_tensor(shifts, dtype=dt, device=q.device)
        sub_t = torch.zeros(s, dtype=dt, device=q.device)
    return _newton_scan(A, q, s, diag_t, sub_t)


def _diag_sub(B: np.ndarray, s: int):
    diag = np.diagonal(B)[:s].copy()
    sub = np.zeros(s, dtype=B.dtype)
    if s > 1:
        sub[1:] = np.diagonal(B, 1)[: s - 1]
    return diag, sub


def matrix_powers_from_B(A: Operator, q: torch.Tensor, B: np.ndarray) -> torch.Tensor:
    """Matrix powers driven directly by a change-of-basis matrix B
    ((s+1, s), unit subdiagonal); real B keeps the vector's dtype."""
    B = np.asarray(B)
    s = B.shape[1]
    dt = _complex_dtype(q.dtype) if np.iscomplexobj(B) else q.dtype
    q = q.to(dt)
    diag, sub = _diag_sub(B, s)
    return _newton_scan(A, q, s, torch.as_tensor(diag, dtype=dt, device=q.device),
                        torch.as_tensor(sub, dtype=dt, device=q.device))


def _kernel_eligible(A: Operator, q: torch.Tensor) -> bool:
    """A real DIA operator and vector of one float dtype within the
    kernels' diagonal limit go to K1/K2 (on CPU the wrappers take their
    plain versions, the same recurrence)."""
    from ca_lanczos_tpu_torch.ops.cuda_spmv import MAX_DIAGS
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

    return (
        isinstance(A, DiaMatrix)
        and q.dtype in (torch.float32, torch.float64)
        and A.dtype == q.dtype
        and len(A.offsets) <= MAX_DIAGS
    )


def matrix_powers(A: Operator, q: torch.Tensor, s: int, Bk: Optional[np.ndarray],
                  basis: Basis) -> torch.Tensor:
    """Driver-facing dispatcher (reference: ca_lanczos.m:110-118).  Complex
    shifts never reach a kernel."""
    from ca_lanczos_tpu_torch.ops.cuda_ilv import IlvDiaMatrix
    from ca_lanczos_tpu_torch.ops.cuda_spmv import matrix_powers_dia_fused
    from ca_lanczos_tpu_torch.ops.pell import PellMatrix, matrix_powers_pell

    basis = Basis(basis)
    if basis not in (Basis.MONOMIAL, Basis.NEWTON):
        raise ValueError(f"unknown basis {basis}")
    diag = sub = None
    if basis == Basis.NEWTON:
        diag, sub = _diag_sub(np.asarray(Bk), s)
    real = diag is None or not np.iscomplexobj(diag)
    if real and _kernel_eligible(A, q):
        return matrix_powers_dia_fused(A, q, s, diag, sub)
    if real and isinstance(A, IlvDiaMatrix) and not q.is_complex():
        return A.powers(q, s, diag, sub)
    if real and isinstance(A, PellMatrix) and not q.is_complex():
        return matrix_powers_pell(A, q, s, diag, sub)
    if basis == Basis.MONOMIAL:
        return matrix_powers_monomial(A, q, s)
    return matrix_powers_from_B(A, q, Bk)
