"""Interleaved-layout banded matrix-powers kernel K3 and its operator.

Counterpart of ``ca_lanczos_tpu/ops/pallas_ilv.py``.  Vectors are J=8
row-interleaved, ``x_il[r*nq + q] = x[J*q + r]`` (``nq = n/J``), so the
operator is ``P A P^T``; Gram products, axpys and norms are
permutation-invariant, so a CA-Lanczos solve runs in the permuted space
and only Ritz vectors are decoded.

* K3 ``dia_powers_ilv`` (``csrc/ilv_powers.cu``) runs the three-term
  recurrence in the interleaved index space itself; plain version
  ``dia_powers_ilv_ref`` (decode, shifted-slice recurrence, encode).
* ``IlvDiaMatrix`` stores the interleaved planes ``(nd, n)`` and the
  normal-layout companion planes ``dia_data``.  The TPU kernel's
  tile-major, halo-duplicated plane layout and its tile size ``tq`` are
  Mosaic DMA artifacts and are gone; the q-halo bound ``s*ceil(|o|/8) <=
  WQ`` (``s_max`` and the ``ValueError``) is kept so callers see the same
  API.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops._cuda_build import load
from ca_lanczos_tpu_torch.ops.cuda_spmv import (
    MAX_DIAGS,
    MAX_STEPS,
    SMEM_MAX,
    SMEM_TARGET,
    check_operands,
    host_coefs,
    three_term_ref,
)
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, _dia_matvec

J = 8  # row interleave factor
WQ = 1024  # q-halo bound of the API (pallas_ilv.WQ)

LAUNCHES = {"dia_powers_ilv": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    f"dia_powers_ilv_{t}": (
        [_P, _P, _I, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _P], _I)
    for t in ("f32", "f64")
}


def _lib():
    return load("ilv_powers", _SIGS)


def ilv_encode(x):
    """x (n, ...) -> interleaved: out[r*nq + q] = x[J*q + r] along axis 0.
    numpy in, numpy out; tensor in, tensor out (same device)."""
    n = x.shape[0]
    rest = tuple(x.shape[1:])
    if isinstance(x, torch.Tensor):
        return x.reshape((n // J, J) + rest).transpose(0, 1).reshape((n,) + rest)
    x = np.asarray(x)
    return np.ascontiguousarray(np.swapaxes(x.reshape((n // J, J) + rest), 0, 1)).reshape(
        (n,) + rest)


def ilv_decode(y):
    """Inverse of :func:`ilv_encode`."""
    n = y.shape[0]
    rest = tuple(y.shape[1:])
    if isinstance(y, torch.Tensor):
        return y.reshape((J, n // J) + rest).transpose(0, 1).reshape((n,) + rest)
    y = np.asarray(y)
    return np.ascontiguousarray(np.swapaxes(y.reshape((J, n // J) + rest), 0, 1)).reshape(
        (n,) + rest)


def _encode_planes(data: torch.Tensor) -> torch.Tensor:
    nd, n = data.shape
    return data.reshape(nd, n // J, J).transpose(1, 2).reshape(nd, n).contiguous()


def _decode_planes(data_il: torch.Tensor) -> torch.Tensor:
    nd, n = data_il.shape
    return data_il.reshape(nd, J, n // J).transpose(1, 2).reshape(nd, n)


def max_carry(offsets: Sequence[int]) -> int:
    """q-columns a diagonal moves per step: max ceil(|o|/J)."""
    return max(((abs(o) + J - 1) // J for o in offsets), default=0)


def _halo_guard(offsets: Sequence[int], s: int) -> None:
    mc = max_carry(offsets)
    if s * mc > WQ:
        raise ValueError(
            f"ilv halo overflow: s={s} steps with max diagonal offset "
            f"{max(abs(o) for o in offsets)} need s*ceil(|o|/{J}) = "
            f"{s * mc} q-halo elements but WQ={WQ}; lower s or use "
            "a DiaMatrix (ops.cuda_spmv) for this bandwidth"
        )


ROW_LANES = 64  # threads per interleaved row of a K3 block (512 = 8 rows)
# The register kernels csrc/ilv_powers.cu instantiates: per element size,
# diagonal capacity NDM -> window columns per thread CPT (Lq = 64*CPT).
# Chosen so the per-thread coefficients (NDM*CPT values) stay in registers.
REG_CPT = {4: {3: 4, 5: 4, 9: 4, 16: 2}, 8: {3: 4, 5: 4, 9: 2, 16: 2}}


class IlvPlan(NamedTuple):
    """One K3 launch: window columns ``lq`` = ``tq`` owned + 2 * ``hq``
    halo, ``g`` guard columns per side of the step buffers, the register
    kernel (``reg``) or the shared-memory fallback, and its shared memory
    in bytes."""

    lq: int
    tq: int
    hq: int
    g: int
    reg: bool
    smem: int


def ilv_smem(nd: int, lq: int, g: int, item: int, reg: bool) -> int:
    """Shared memory of a K3 launch (csrc/ilv_powers.cu ``smem_bytes``):
    the staged planes and two step buffers; the register kernel adds the
    next tile's x and x_prev and ``g`` guard columns a side of the step
    buffers, the fallback its (8, nd) source-row and carry tables."""
    if reg:
        return ((nd + 2) * J * lq + 2 * J * (lq + 2 * g)) * item
    return (nd + 2) * J * lq * item + 2 * J * nd * 4


def ilv_plan(nd: int, mc: int, s: int, dtype: torch.dtype) -> Optional[IlvPlan]:
    """Window of one K3 launch, or None when no s-step window fits shared
    memory (the wrapper then chains s single steps).  For s > 1 the halo
    must be at most the tile, as for K1.  The register kernel serves
    nd <= 16 at its fixed Lq when that leaves a tile; otherwise the
    fallback takes the widest power-of-two tile that fits, preferring
    room for two blocks per SM."""
    if nd > MAX_DIAGS or s > MAX_STEPS:
        return None
    item = torch.empty((), dtype=dtype).element_size()
    hq = s * mc
    min_tq = 1 if s == 1 else max(hq, 1)
    ndm = next((k for k in sorted(REG_CPT[item]) if nd <= k), None)
    if ndm is not None:
        lq = ROW_LANES * REG_CPT[item][ndm]
        smem = ilv_smem(nd, lq, mc, item, True)
        if lq - 2 * hq >= min_tq and smem <= SMEM_MAX:
            return IlvPlan(lq, lq - 2 * hq, hq, mc, True, smem)
    for budget in (SMEM_TARGET, SMEM_MAX):
        for tq in (1024, 512, 256, 128, 64, 32):
            smem = ilv_smem(nd, tq + 2 * hq, mc, item, False)
            if tq >= min_tq and smem <= budget:
                return IlvPlan(tq + 2 * hq, tq, hq, mc, False, smem)
    return None


def pick_tq(nd: int, mc: int, s: int, dtype: torch.dtype) -> int:
    """q-columns owned by one K3 tile (:func:`ilv_plan`), or 0 when the
    s-step window does not fit shared memory."""
    plan = ilv_plan(nd, mc, s, dtype)
    return plan.tq if plan else 0


def dia_powers_ilv_ref(data_il, x_il, coefs, offsets, s, x_prev=None):
    """Plain version of K3: decode the planes and vectors, run the
    shifted-slice recurrence in the normal layout, encode the outputs."""
    data = _decode_planes(data_il)
    V, last = three_term_ref(
        lambda v: _dia_matvec(tuple(offsets), data, v), ilv_decode(x_il),
        host_coefs(coefs, s), s, None if x_prev is None else ilv_decode(x_prev))
    return ilv_encode(V.T).T.contiguous(), ilv_encode(last)


def _launch(data_il, x_il, x_prev, c, offsets, s, plan: IlvPlan, V, last):
    n = x_il.shape[0]
    offs = (ctypes.c_int * len(offsets))(*offsets)
    fn = getattr(_lib(), "dia_powers_ilv_" + ("f32" if x_il.dtype == torch.float32 else "f64"))
    with torch.cuda.device(x_il.device):
        rc = fn(data_il.data_ptr(), offs, len(offsets), x_il.data_ptr(),
                None if x_prev is None else x_prev.data_ptr(),
                None if c is None else c.ctypes.data, V.data_ptr(), last.data_ptr(),
                n, s, plan.lq, plan.tq, plan.hq, plan.g, int(plan.reg),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dia_powers_ilv launch failed: CUDA error {rc}")
    LAUNCHES["dia_powers_ilv"] += 1


def dia_powers_ilv(data_il: torch.Tensor, x_il: torch.Tensor, coefs,
                   offsets: Sequence[int], s: int,
                   x_prev: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: s recurrence steps in the interleaved layout.  ``data_il`` are
    the interleaved planes (nd, n), ``coefs`` (s, 2) or None (monomial),
    ``x_prev`` the step before x (None: zero).  Returns (V_il (s, n),
    last_il (n,))."""
    offsets = tuple(int(o) for o in offsets)
    if not 0 < len(offsets) <= MAX_DIAGS or not 0 < s <= MAX_STEPS:
        raise ValueError(f"K3 takes 1..{MAX_DIAGS} diagonals and 1..{MAX_STEPS} steps")
    _halo_guard(offsets, s)
    check_operands(data_il, x_il, *(() if x_prev is None else (x_prev,)))
    n = x_il.shape[0]
    if x_il.ndim != 1 or n % J or data_il.shape != (len(offsets), n) or (
            x_prev is not None and x_prev.shape != x_il.shape):
        raise ValueError(f"shapes data {tuple(data_il.shape)}, x {tuple(x_il.shape)}")
    c = host_coefs(coefs, s)
    if x_il.device.type == "cpu":
        return dia_powers_ilv_ref(data_il, x_il, c, offsets, s, x_prev)
    mc = max_carry(offsets)
    V = torch.empty((s, n), dtype=x_il.dtype, device=x_il.device)
    last = torch.empty_like(x_il)
    plan = ilv_plan(len(offsets), mc, s, x_il.dtype)
    if plan:
        _launch(data_il, x_il, x_prev, c, offsets, s, plan, V, last)
        return V, last
    # The s-step window does not fit: chain s single steps through x_prev.
    plan = ilv_plan(len(offsets), mc, 1, x_il.dtype)
    if plan is None:
        raise ValueError(
            f"K3 window for {len(offsets)} diagonals of bandwidth "
            f"{max(abs(o) for o in offsets)} exceeds shared memory even at s=1; "
            "use a DiaMatrix"
        )
    prev, cur = x_prev, x_il
    for j in range(s):
        _launch(data_il, cur, prev, None if c is None else c[j:j + 1].copy(), offsets, 1,
                plan, V[j], last)
        prev, cur = cur, V[j]
    last.copy_(V[s - 1])
    return V, last


@dataclasses.dataclass(frozen=True)
class IlvDiaMatrix:
    """A DIA operator in the interleaved row layout: represents P A P^T
    where P is the :func:`ilv_encode` permutation.  Construct with
    :meth:`from_dia`."""

    data_il: torch.Tensor  # (nd, n) interleaved planes
    offsets: Tuple[int, ...]
    n_rows: int
    # Normal-layout companion planes (DiaMatrix.data layout): multivector
    # consumers (verification and refine of the fused driver) decode their
    # block once and run the plain DIA product on these.
    dia_data: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.n_rows

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_rows)

    @property
    def dtype(self) -> torch.dtype:
        return self.data_il.dtype

    @property
    def device(self) -> torch.device:
        return self.data_il.device

    @property
    def nnz(self) -> int:
        return sum(self.n_rows - abs(k) for k in self.offsets)

    @property
    def s_max(self) -> int:
        """Largest s the WQ q-halo supports (see the dia_powers_ilv guard)."""
        mc = max_carry(self.offsets)
        return WQ // mc if mc else 10**9

    @property
    def dia(self) -> Optional[DiaMatrix]:
        """Normal-layout companion operator (None if not kept)."""
        if self.dia_data is None:
            return None
        return DiaMatrix(data=self.dia_data, offsets=self.offsets)

    def to(self, device) -> "IlvDiaMatrix":
        return dataclasses.replace(
            self, data_il=self.data_il.to(device),
            dia_data=None if self.dia_data is None else self.dia_data.to(device))

    @staticmethod
    def from_dia(A: DiaMatrix, keep_dia: bool = True) -> "IlvDiaMatrix":
        n = A.data.shape[1]
        if n % J:
            raise ValueError(f"n={n} is not a multiple of the interleave factor {J}")
        # s=1 (matvec) halo bound; s-step callers hit the stricter
        # s*ceil(|o|/J) <= WQ check inside dia_powers_ilv.
        wmax = max(abs(o) for o in A.offsets) if A.offsets else 0
        if wmax > J * WQ:
            raise ValueError(f"bandwidth {wmax} exceeds the ilv halo {J * WQ}")
        return IlvDiaMatrix(
            data_il=_encode_planes(A.data), offsets=tuple(A.offsets), n_rows=n,
            dia_data=A.data if keep_dia else None,
        )

    def encode(self, x):
        return ilv_encode(x)

    def decode(self, y):
        return ilv_decode(y)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """(P A P^T) x for an interleaved-layout x (n,) or block (n, k)."""
        if x.is_complex():
            raise TypeError("IlvDiaMatrix is a real-arithmetic carrier; use a DiaMatrix")
        if x.ndim == 2:
            if self.dia_data is None:
                raise ValueError("a block product needs IlvDiaMatrix(keep_dia=True)")
            return ilv_encode(self.dia.matvec(ilv_decode(x)))
        _, last = dia_powers_ilv(self.data_il, x.contiguous(), None, self.offsets, 1)
        return last

    def powers(self, q: torch.Tensor, s: int, diag=None, sub=None) -> torch.Tensor:
        """[q, Aq, ..., A^s q] (interleaved, (n, s+1)), optionally
        Newton-shifted: V[:,k+1] = A V[:,k] - diag[k] V[:,k] - sub[k] V[:,k-1]."""
        coefs = None
        if diag is not None:
            coefs = np.zeros((s, 2))
            coefs[:, 0] = np.asarray(diag, np.float64)[:s]
            if sub is not None:
                coefs[:, 1] = np.asarray(sub, np.float64)[:s]
        V, _ = dia_powers_ilv(self.data_il, q, coefs, self.offsets, s)
        return torch.cat([q[None, :], V], dim=0).T
