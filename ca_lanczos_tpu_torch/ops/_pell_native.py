"""ctypes binding to the native PELL encoder (``native/pell_encode.cpp``).

Counterpart of ``ca_lanczos_tpu/ops/_pell_native.py``.  The numpy encoder
in ``ops/pell.py`` is global-argsort based and its grouped variant packs
slot-tiles in a per-block Python loop, minutes of host time at 10M rows.
The native encoder walks 128-row blocks independently (OpenMP): planning
is O(nnz) with no global sort, and the plane scatter parallelises.  Both
emit the same plane layout (slot assignments may differ; both are
checked by matvec parity).

Plan/emit split: planning returns only per-entry assignments, so
``encoding="auto"`` prices every encoding before allocating and scattering
the (ntiles*K, tile) planes of the winner only.

The library is built from the checkout's source by
``utils._native_build`` into ``build/native/``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ca_lanczos_tpu_torch.utils._native_build import NATIVE_SRC, build_native

LANES = 128
SLOTS = 8
KTMAX = 64  # must match native/pell_encode.cpp

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_i64 = ctypes.c_int64
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build_native(NATIVE_SRC / "pell_encode.cpp", ["-O3", "-fopenmp"])))
    except (RuntimeError, OSError):
        return None
    lib.pell_plan_unit.restype = _i64
    lib.pell_plan_unit.argtypes = [
        _i64, _i64, _i64, _p_i64, _p_i32, _p_i32, _p_i32, _i64,
        _p_i32, _p_i32,
    ]
    lib.pell_emit_unit.restype = None
    lib.pell_emit_unit.argtypes = [
        _i64, _i64, _p_i64, _p_i32, ctypes.c_void_p, ctypes.c_int,
        _p_i32, _p_i32, _i64, ctypes.c_void_p, _p_i8, _p_i32,
    ]
    lib.pell_plan_grouped.restype = _i64
    lib.pell_plan_grouped.argtypes = [
        _i64, _i64, _i64, _p_i64, _p_i32, _p_i32, _p_i32, _i64, _i64,
        _i64, _p_i32, _p_i8, _p_i32,
    ]
    lib.pell_emit_grouped.restype = None
    lib.pell_emit_grouped.argtypes = [
        _i64, _i64, _p_i64, _p_i32, ctypes.c_void_p, ctypes.c_int,
        _p_i32, _p_i8, _p_i32, _i64, _i64, ctypes.c_void_p, _p_i16,
        _p_i32,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


class _Csr:
    """Contiguous int64/int32 views of a scipy CSR the C ABI accepts."""

    def __init__(self, indptr, indices, data, dtype):
        self.indptr = np.ascontiguousarray(indptr, np.int64)
        self.indices = np.ascontiguousarray(indices, np.int32)
        self.data = np.ascontiguousarray(data, dtype)
        self.dbl = int(np.dtype(dtype) == np.float64)


def plan_unit(csr: _Csr, n, tile, sr, wins, win_cnt):
    """(ch, uord, K): per-entry chunk + unit ordinal, padded slot count."""
    lib = _load()
    nnz = len(csr.indices)
    ch = np.empty(nnz, np.int32)
    uord = np.empty(nnz, np.int32)
    u_max = lib.pell_plan_unit(
        n, tile, sr, csr.indptr, csr.indices, wins, win_cnt,
        wins.shape[1] if wins.ndim == 2 else 1,
        ch, uord,
    )
    K = SLOTS * (-(-max(int(u_max), 1) // SLOTS))
    return ch, uord, K


def emit_unit(csr: _Csr, n, tile, ch, uord, K, dtype):
    lib = _load()
    ntiles = -(-n // tile)
    B = tile // LANES
    ntiles_pad8 = 8 * (-(-ntiles // 8))
    vals = np.zeros((ntiles * K, tile), dtype)
    lidx = np.zeros((ntiles * K, tile), np.int8)
    cbase = np.zeros((ntiles_pad8, B * K), np.int32)
    lib.pell_emit_unit(
        n, tile, csr.indptr, csr.indices,
        csr.data.ctypes.data_as(ctypes.c_void_p), csr.dbl,
        ch, uord, K, vals.ctypes.data_as(ctypes.c_void_p), lidx, cbase,
    )
    return vals, lidx, cbase, K


def plan_grouped(csr: _Csr, n, tile, sr, wins, win_cnt, max_units=512,
                 nw=2):
    """(slot, sub, bases, K2) or None when the constraints fail (the
    caller falls back to the unit encoding, like the numpy encoder).  nw:
    windows per slot-tile (2 = two spread-4 windows, 4 = four spread-2;
    ops/pell.py GROUPED_GEOM)."""
    lib = _load()
    nnz = len(csr.indices)
    ntiles = -(-n // tile)
    nblocks = ntiles * (tile // LANES)
    slot = np.empty(nnz, np.int32)
    sub = np.empty(nnz, np.int8)
    bases = np.zeros(nblocks * KTMAX * 4, np.int32)  # stride 4 always
    kt2 = lib.pell_plan_grouped(
        n, tile, sr, csr.indptr, csr.indices, wins, win_cnt,
        wins.shape[1] if wins.ndim == 2 else 1, max_units, nw,
        slot, sub, bases,
    )
    if kt2 == 0:
        return None
    return slot, sub, bases, int(kt2) * SLOTS


def emit_grouped(csr: _Csr, n, tile, slot, sub, bases, K2, dtype, nw=2):
    lib = _load()
    ntiles = -(-n // tile)
    B = tile // LANES
    KT2 = K2 // SLOTS
    ntiles_pad8 = 8 * (-(-ntiles // 8))
    vals = np.zeros((ntiles * K2, tile), dtype)
    idx16 = np.zeros((ntiles * K2, tile), np.int16)
    cbase2 = np.zeros((ntiles_pad8, B * KT2 * nw), np.int32)
    lib.pell_emit_grouped(
        n, tile, csr.indptr, csr.indices,
        csr.data.ctypes.data_as(ctypes.c_void_p), csr.dbl,
        slot, sub, bases, KT2, nw,
        vals.ctypes.data_as(ctypes.c_void_p), idx16, cbase2,
    )
    return vals, idx16, cbase2, K2
