"""Banded (DIA) matrix-powers kernels K1 and K2: wrappers, plain versions,
K1 planner.

Counterpart of ``ca_lanczos_tpu/ops/pallas_spmv.py``.  The kernels are
CUDA C++ in ``csrc/dia_powers.cu`` (see its header for what each replaces
and what bounds it):

* K1 ``dia_powers_fused`` — s steps of the three-term recurrence with the
  matrix read once per s steps; plain version ``dia_powers_fused_ref``.
  :func:`k1_plan` picks its kernel: the register kernel for distinct
  offsets inside +-8, else the shared-memory fallback, else K2 steps.
* K2 ``dia_power_step`` — one step ``y = A x - c0 x - c1 v_prev``; plain
  version ``dia_power_step_ref``.  It is K1's fallback when K1's halo does
  not fit shared memory, and, registered in ``ops.spmv.CUDA_MATVEC``, the
  ``spmv`` of a DiaMatrix and a real vector on CUDA.

A complex vector on real planes of its precision (complex128 on float64,
complex64 on float32) goes through the same kernels as its real and
imaginary parts, one launch each (:func:`by_parts`): the operator and the
recurrence coefficients are real, so that is the complex product.  Complex
coefficients never reach a kernel.

A wrapper takes its plain version only for CPU tensors.  For a CUDA tensor
it launches the kernel or raises; it never casts.  Coefficients are host
numbers (``(s, 2)`` rows ``[shift, sub]``), passed to the kernel by value.
``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops._cuda_build import load
from ca_lanczos_tpu_torch.ops.spmv import CUDA_MATVEC, DiaMatrix, _dia_matvec

MAX_DIAGS = 128  # DIA_MAX_DIAGS in csrc/dia_common.cuh
MAX_STEPS = 64  # DIA_MAX_STEPS
SMEM_TARGET = 96 * 1024  # two resident blocks per SM
SMEM_MAX = 227 * 1024  # per-block dynamic shared memory on sm_90

# dia_powers_fused counts every K1 launch, dia_powers_reg / _smem by kernel
LAUNCHES = {"dia_powers_fused": 0, "dia_powers_reg": 0, "dia_powers_smem": 0,
            "dia_power_step": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGS = {
    f"dia_powers_fused_{t}": ([_P, _P, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P], _I)
    for t in ("f32", "f64")
}
_SIGS.update({
    f"dia_power_step_{t}": ([_P, _P, _I, _P, _P, _P, _P, _LL, _P], _I)
    for t in ("f32", "f64")
})


def _lib():
    return load("dia_powers", _SIGS)


def check_operands(*tensors: torch.Tensor) -> None:
    """The kernels take contiguous real float32/float64 tensors of one
    dtype on one device; raise on anything else (no casting)."""
    t0 = tensors[0]
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a tensor, got {type(t).__name__}")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"DIA kernels take float32/float64, got {t.dtype}")
        if t.dtype != t0.dtype:
            raise TypeError(f"mixed dtypes {t0.dtype} and {t.dtype}")
        if t.device != t0.device:
            raise ValueError(f"mixed devices {t0.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("DIA kernels take contiguous tensors")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t0.device}")


def host_coefs(coefs, s: int) -> Optional[np.ndarray]:
    """(s, 2) float64 host array of per-step [shift, sub] coefficients, or
    None for the monomial recurrence."""
    if coefs is None:
        return None
    if isinstance(coefs, torch.Tensor):
        if coefs.device.type != "cpu":
            raise ValueError("coefficients are host numbers (numpy or a CPU tensor)")
        coefs = coefs.numpy()
    c = np.asarray(coefs)
    if np.iscomplexobj(c):
        raise TypeError("complex shifts never reach a DIA kernel")
    c = np.ascontiguousarray(c, np.float64).reshape(-1, 2)
    if c.shape[0] < s:
        raise ValueError(f"need {s} coefficient rows, got {c.shape[0]}")
    return np.ascontiguousarray(c[:s])


def _check_diags(offsets: Sequence[int], s: int) -> None:
    if not 0 < len(offsets) <= MAX_DIAGS:
        raise ValueError(f"DIA kernels take 1..{MAX_DIAGS} diagonals, got {len(offsets)}")
    if not 0 < s <= MAX_STEPS:
        raise ValueError(f"DIA kernels take 1..{MAX_STEPS} steps, got s={s}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the on-card reference).
# ---------------------------------------------------------------------------


def three_term_ref(apply, x: torch.Tensor, coefs: Optional[np.ndarray], s: int,
                   x_prev: Optional[torch.Tensor] = None):
    """w_{j+1} = apply(w_j) - c[j,0] w_j - c[j,1] w_{j-1}, w_0 = x,
    w_{-1} = x_prev or 0.  Returns (V (s, n), last (n,))."""
    c = None if coefs is None else torch.as_tensor(coefs, dtype=x.dtype, device=x.device)
    V = x.new_empty((s,) + tuple(x.shape))
    prev = torch.zeros_like(x) if x_prev is None else x_prev
    cur = x
    for j in range(s):
        w = apply(cur)
        if c is not None:
            w = w - c[j, 0] * cur - c[j, 1] * prev
        V[j] = w
        prev, cur = cur, w
    return V, V[s - 1].clone()


def dia_powers_fused_ref(data, x, coefs, offsets, s):
    """Plain version of K1: (V (s, n), last (n,))."""
    c = host_coefs(coefs, s)
    return three_term_ref(lambda v: _dia_matvec(tuple(offsets), data, v), x, c, s)


def dia_power_step_ref(data, x, v_prev, coefs, offsets):
    """Plain version of K2: sum_d data[d]*x[i+off_d] - c0 x - c1 v_prev."""
    y = _dia_matvec(tuple(offsets), data, x)
    c = host_coefs(coefs, 1)
    if c is None:
        return y
    ct = torch.as_tensor(c[0], dtype=x.dtype, device=x.device)
    y = y - ct[0] * x
    if v_prev is not None:
        y = y - ct[1] * v_prev
    return y


# ---------------------------------------------------------------------------
# K1 planner and wrappers.
# ---------------------------------------------------------------------------

K1_THREADS = 256  # K1_THREADS in csrc/dia_powers.cu
# The register kernels csrc/dia_powers.cu instantiates are keyed by band
# capacity BW (offsets inside +-BW); per element size, the quads of 4 rows
# each thread owns (window = 4 * K1_THREADS * quads rows), chosen so its
# 4 * (2*BW + 1) coefficients per quad stay in registers.
K1_REG_QUADS = {4: {1: 2, 2: 2, 4: 1, 8: 1}, 8: {1: 1, 2: 1, 4: 1, 8: 1}}


class K1Plan(NamedTuple):
    """One K1 launch: ``variant`` "reg" (register kernel), "smem" (the
    shared-memory fallback) or "steps" (no s-step window fits: s launches
    of K2); ``tile`` rows owned per tile with ``halo`` rows a side;
    ``quads`` per thread and band capacity ``bw`` of the register kernel;
    ``smem`` bytes of shared memory per block."""

    variant: str
    tile: int
    halo: int
    quads: int
    bw: int
    smem: int


STEPS_PLAN = K1Plan("steps", 0, 0, 0, 0, 0)


def k1_smem(nd: int, window: int, bw: int, item: int) -> int:
    """Shared memory of a K1 block (csrc/dia_powers.cu ``fused``).  The
    register kernel (``bw`` > 0) stages the next tile's planes and x and
    keeps two step buffers with a guard of whole quads a side; the fallback
    holds the planes and two vectors."""
    if bw:
        guard = 4 * ((bw + 3) // 4)
        return ((nd + 1) * window + 2 * (window + 2 * guard)) * item
    return (nd + 2) * window * item


def k1_plan(nd: int, wmax: int, s: int, dtype: torch.dtype, distinct: bool = True) -> K1Plan:
    """How K1 runs ``s`` steps of ``nd`` diagonals at most ``wmax`` from the
    main one.  The register kernel takes distinct offsets inside the widest
    band it is built for, with its halo rounded up to a quad and at most
    the tile for s > 1; otherwise the fallback takes the widest tile of
    4096..256 rows whose halo ``s*max(wmax, 1)`` is at most the tile and
    that fits shared memory, preferring room for two blocks per SM (the
    first port's rule, so every shape it ran still runs); otherwise K2."""
    if not 0 < nd <= MAX_DIAGS or not 0 < s <= MAX_STEPS:
        return STEPS_PLAN
    item = torch.empty((), dtype=dtype).element_size()
    quads = K1_REG_QUADS[item]
    bw = next((b for b in sorted(quads) if b >= wmax), None)
    if distinct and bw is not None:
        window = 4 * K1_THREADS * quads[bw]
        halo = -(-s * wmax // 4) * 4
        tile = window - 2 * halo
        smem = k1_smem(nd, window, bw, item)
        if tile >= max(4, halo if s > 1 else 0) and smem <= SMEM_MAX:
            return K1Plan("reg", tile, halo, quads[bw], bw, smem)
    halo = s * max(wmax, 1)
    for budget in (SMEM_TARGET, SMEM_MAX):
        for t in (4096, 2048, 1024, 512, 256):
            smem = k1_smem(nd, t + 2 * halo, 0, item)
            if halo <= t and smem <= budget:
                return K1Plan("smem", t, halo, 0, 0, smem)
    return STEPS_PLAN


def k1_plan_for(offsets: Sequence[int], s: int, dtype: torch.dtype) -> K1Plan:
    """:func:`k1_plan` for these offsets (a repeated one rules out the
    register kernel)."""
    return k1_plan(len(offsets), max(abs(o) for o in offsets), s, dtype,
                   distinct=len(set(offsets)) == len(offsets))


def fused_tile(nd: int, wmax: int, s: int, dtype: torch.dtype) -> int:
    """Rows owned by one K1 tile (:func:`k1_plan`), or 0 when no s-step
    window fits (the caller then runs s launches of K2)."""
    return k1_plan(nd, wmax, s, dtype).tile


def dia_powers_fused(data: torch.Tensor, x: torch.Tensor, coefs, offsets: Sequence[int],
                     s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: s recurrence steps from x on DIA planes ``data (nd, n)``.
    Returns (V (s, n), last (n,)); ``coefs`` (s, 2) or None (monomial)."""
    offsets = tuple(int(o) for o in offsets)
    _check_diags(offsets, s)
    check_operands(data, x)
    n = x.shape[0]
    if data.shape != (len(offsets), n) or x.ndim != 1:
        raise ValueError(f"shapes data {tuple(data.shape)}, x {tuple(x.shape)}")
    c = host_coefs(coefs, s)
    if x.device.type == "cpu":
        return dia_powers_fused_ref(data, x, c, offsets, s)
    plan = k1_plan_for(offsets, s, x.dtype)
    if plan.variant == "steps":
        raise ValueError(f"no K1 window fits s={s}, bandwidth "
                         f"{max(abs(o) for o in offsets)}; use dia_power_step")
    V = torch.empty((s, n), dtype=x.dtype, device=x.device)
    last = torch.empty_like(x)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    fn = getattr(_lib(), "dia_powers_fused_" + ("f32" if x.dtype == torch.float32 else "f64"))
    with torch.cuda.device(x.device):
        rc = fn(data.data_ptr(), offs, len(offsets), x.data_ptr(),
                None if c is None else c.ctypes.data, V.data_ptr(), last.data_ptr(),
                n, s, plan.tile, plan.halo, plan.bw, plan.quads,
                torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "dia_powers_fused")
    LAUNCHES["dia_powers_fused"] += 1
    LAUNCHES["dia_powers_" + plan.variant] += 1
    return V, last


def dia_power_step(data: torch.Tensor, x: torch.Tensor, v_prev: Optional[torch.Tensor],
                   coefs, offsets: Sequence[int]) -> torch.Tensor:
    """K2: y = sum_d data[d]*x[i+off_d] - c0 x - c1 v_prev; ``coefs`` is
    (c0, c1) or None (plain matvec), ``v_prev`` may be None (zero)."""
    offsets = tuple(int(o) for o in offsets)
    _check_diags(offsets, 1)
    ts = (data, x) if v_prev is None else (data, x, v_prev)
    check_operands(*ts)
    n = x.shape[0]
    if data.shape != (len(offsets), n) or x.ndim != 1 or (
            v_prev is not None and v_prev.shape != x.shape):
        raise ValueError(f"shapes data {tuple(data.shape)}, x {tuple(x.shape)}")
    c = host_coefs(coefs, 1)
    if x.device.type == "cpu":
        return dia_power_step_ref(data, x, v_prev, c, offsets)
    y = torch.empty_like(x)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    fn = getattr(_lib(), "dia_power_step_" + ("f32" if x.dtype == torch.float32 else "f64"))
    with torch.cuda.device(x.device):
        rc = fn(data.data_ptr(), offs, len(offsets), x.data_ptr(),
                None if v_prev is None else v_prev.data_ptr(),
                None if c is None else c.ctypes.data, y.data_ptr(), n,
                torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "dia_power_step")
    LAUNCHES["dia_power_step"] += 1
    return y


def by_parts(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of a complex x as fn(Re x) + i fn(Im x): two calls on
    contiguous real vectors, for an ``fn`` that is real-linear with real
    operator and coefficients (a K1/K2 launch each on CUDA)."""
    return torch.complex(fn(x.real.contiguous()), fn(x.imag.contiguous()))


def matrix_powers_dia_steps(A, q: torch.Tensor, s: int, diag=None, sub=None) -> torch.Tensor:
    """[q, P_1(A)q, ..., P_s(A)q] (n, s+1) through s launches of K2
    (counterpart of ``matrix_powers_dia_pallas``)."""
    diag = np.zeros(s) if diag is None else np.asarray(diag, np.float64)
    sub = np.zeros(s) if sub is None else np.asarray(sub, np.float64)
    cols = [q]
    v_prev = None
    v = q
    for k in range(s):
        w = dia_power_step(A.data, v, v_prev, (diag[k], sub[k]), A.offsets)
        cols.append(w)
        v_prev, v = v, w
    return torch.stack(cols, dim=1)


def matrix_powers_dia_fused(A, q: torch.Tensor, s: int, diag=None, sub=None) -> torch.Tensor:
    """Fused-s matrix powers (n, s+1) through K1, or K2 when no K1 window
    fits (mirror of the TPU ``fused_tile`` returning 0); a complex q by
    its real and imaginary parts."""
    if q.is_complex():
        return by_parts(lambda v: matrix_powers_dia_fused(A, v, s, diag, sub), q)
    if k1_plan_for(tuple(A.offsets), s, q.dtype).variant == "steps":
        return matrix_powers_dia_steps(A, q, s, diag, sub)
    coefs = None
    if diag is not None or sub is not None:
        coefs = np.zeros((s, 2))
        if diag is not None:
            coefs[:, 0] = np.asarray(diag, np.float64)[:s]
        if sub is not None:
            coefs[:, 1] = np.asarray(sub, np.float64)[:s]
    V, _ = dia_powers_fused(A.data, q, coefs, A.offsets, s)
    return torch.cat([q[:, None], V.T], dim=1)


def dia_matvec(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """``spmv`` of a DiaMatrix and a vector on CUDA: one K2 launch with
    zero coefficients when x is f32/f64 of the planes' dtype, two (its
    real and imaginary parts) when x is complex of their precision; the
    plain product otherwise (other dtypes, more than MAX_DIAGS
    diagonals)."""
    if A.data.dtype in (torch.float32, torch.float64) and len(A.offsets) <= MAX_DIAGS:
        if x.dtype == A.data.dtype:
            return dia_power_step(A.data, x.contiguous(), None, None, A.offsets)
        if x.is_complex() and x.real.dtype == A.data.dtype:
            return by_parts(lambda v: dia_power_step(A.data, v, None, None, A.offsets), x)
    return A.matvec(x)


CUDA_MATVEC[DiaMatrix] = dia_matvec
