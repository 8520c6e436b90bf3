"""General-sparsity (PELL) step kernels K4 and K5: wrappers and dispatch.

Counterpart of ``ca_lanczos_tpu/ops/pell.py``'s ``_pell_step``.  The
kernels are CUDA C++ in ``csrc/pell.cu`` (see its header for what each
replaces and what bounds it):

* K4 ``pell_step_unit`` — unit encoding (int8 lanes);
* K5 ``pell_step_grouped`` — the grouped encodings, one kernel templated
  on the window geometry (``GROUPED_GEOM``: grouped NW=2, grouped4 NW=4).

Both read only the slots below ``A.slot_count`` of each 128-row group
(the slots past it hold zero values).

Both compute one step ``y = A x - d x - sb v_prev`` on vectors of length
``A.n_x``; the plain version is ``ops.pell.pell_step_ref``.  ``pell_step``
takes the plain version only for CPU tensors.  For CUDA tensors it
launches the kernel or raises; it never casts.  ``LAUNCHES`` counts
kernel launches.  On import this module registers ``pell_matvec`` in
``ops.spmv.CUDA_MATVEC``, so ``spmv`` of a PellMatrix and a CUDA vector is
one launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ca_lanczos_tpu_torch.ops._cuda_build import load
from ca_lanczos_tpu_torch.ops.pell import (
    GROUPED_GEOM,
    LANES,
    PellMatrix,
    pell_apply,
    pell_step_ref,
)
from ca_lanczos_tpu_torch.ops.spmv import CUDA_MATVEC

LAUNCHES = {"pell_step_unit": 0, "pell_step_grouped": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGS = {
    f"pell_unit_{t}": ([_P, _P, _P, _P, _P, _P, _P, _D, _D, _P, _I, _I, _I, _I, _I, _P], _I)
    for t in ("f32", "f64")
}
_SIGS.update({
    f"pell_grouped_{t}": ([_P, _P, _P, _P, _P, _P, _P, _D, _D, _P, _I, _I, _I, _I, _I, _I, _P],
                          _I)
    for t in ("f32", "f64")
})


def _lib():
    return load("pell", _SIGS)


def check_operands(A: PellMatrix, x: torch.Tensor, v_prev: Optional[torch.Tensor],
                   out: Optional[torch.Tensor]) -> None:
    """The kernels take contiguous planes of the encoder's dtypes and
    contiguous (n_x,) vectors of the planes' float dtype, all on one
    device; raise on anything else (no casting)."""
    if A.enc != "unit" and A.enc not in GROUPED_GEOM:
        raise ValueError(f"unknown PELL encoding {A.enc!r}")
    want_idx = torch.int16 if A.enc in GROUPED_GEOM else torch.int8
    if A.vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"PELL planes must be float32/float64, got {A.vals.dtype}")
    if A.lidx.dtype != want_idx or A.cbase.dtype != torch.int32 or (
            A.span_row.dtype != torch.int32):
        raise TypeError(f"PELL index planes: lidx {A.lidx.dtype} (want {want_idx}), "
                        f"cbase {A.cbase.dtype}, span_row {A.span_row.dtype} (want int32)")
    if A.slot_count.dtype != torch.int32 or A.slot_count.shape != (A.ntiles, A.tile // LANES):
        raise ValueError(f"slot_count must be ({A.ntiles}, {A.tile // LANES}) int32, got "
                         f"{tuple(A.slot_count.shape)} {A.slot_count.dtype}")
    vecs = [v for v in (x, v_prev, out) if v is not None]
    for t in (A.vals, A.lidx, A.cbase, A.span_row, A.slot_count, *vecs):
        if t.device != A.vals.device:
            raise ValueError(f"mixed devices {A.vals.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("PELL kernels take contiguous tensors")
    for v in vecs:
        if v.dtype != A.vals.dtype:
            raise TypeError(f"vector dtype {v.dtype} differs from the planes' {A.vals.dtype}")
        if v.shape != (A.n_x,):
            raise ValueError(f"expected a vector of length n_x={A.n_x}, got {tuple(v.shape)}")
    ntk = A.ntiles * A.k_slots
    if A.vals.shape != (ntk, A.tile) or A.lidx.shape != (ntk, A.tile) or (
            A.span_row.shape != (A.ntiles, A.n_win)):
        raise ValueError("PELL planes do not match their statics")


def pell_step(A: PellMatrix, x: torch.Tensor, v_prev: Optional[torch.Tensor] = None,
              d: float = 0.0, sb: float = 0.0,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4/K5: ``y = A x - d x - sb v_prev`` on (n_x,) vectors (zero
    beyond ``A.n``; ``v_prev`` None is zero).  Returns ``out`` (allocated
    when None) with rows [0, n_pad) written; rows past n_pad are zero in a
    fresh output and left as they are in a given one."""
    check_operands(A, x, v_prev, out)
    if x.device.type == "cpu":
        y = pell_step_ref(A, x, v_prev, d, sb)
        if out is None:
            return y
        out[: A.n_pad] = y[: A.n_pad]
        return out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if out is None:
        out = torch.empty_like(x)
        out[A.n_pad:] = 0
    grouped = A.enc in GROUPED_GEOM
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    lib = _lib()
    args = [A.vals.data_ptr(), A.lidx.data_ptr(), A.cbase.data_ptr(), A.span_row.data_ptr(),
            A.slot_count.data_ptr(), x.data_ptr(),
            None if v_prev is None else v_prev.data_ptr(), float(d), float(sb),
            out.data_ptr(), A.ntiles, A.tile, A.k_slots, A.sw // LANES, A.n_win]
    if grouped:
        args.append(GROUPED_GEOM[A.enc][0])
    with torch.cuda.device(x.device):
        fn = getattr(lib, ("pell_grouped_" if grouped else "pell_unit_") + suffix)
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    name = "pell_step_grouped" if grouped else "pell_step_unit"
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def pell_matvec(A: PellMatrix, x: torch.Tensor) -> torch.Tensor:
    """``spmv`` of a PellMatrix and a vector on CUDA: one launch when x
    has the planes' dtype, ``A.matvec`` otherwise (a complex x is two)."""
    if x.dtype == A.vals.dtype:
        return pell_apply(A, x)
    return A.matvec(x)


CUDA_MATVEC[PellMatrix] = pell_matvec
