"""Matrix Market I/O: a ctypes binding to the native C++ parser, with a
pure-Python fallback.

Counterpart of ``ca_lanczos_tpu/utils/mmio.py``.  ``native/mmio.cpp``
streams multi-GB files and expands symmetric storage; it is compiled with
``-O2`` at first use into ``build/native/`` (``utils/_native_build.py``),
never while a module is imported, and the binaries beside the source are
never loaded.  ``load_mtx`` returns COO numpy arrays, ``load_operator``
the port's DIA (banded) or ELL operator on a device, and ``save_mtx``
writes the JAX package's text byte for byte.

Divergences from the JAX package: when the native library does not build
or cannot open a file, ``load_mtx`` still parses in Python but warns
(``RuntimeWarning``): at millions of entries the fallback costs minutes.
``native_available()`` says whether the native parser is in use.
``load_mtx`` raises ValueError on a ``complex`` field or ``hermitian``
symmetry, which the JAX package reads as a real matrix: the real part
of each entry, and Hermitian storage's lower triangle alone.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.utils._native_build import NATIVE_SRC, build_native

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load_lib() -> Optional[ctypes.CDLL]:
    """Build (once per process) and bind the native parser; None when the
    source is missing or the compile fails."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build_native(NATIVE_SRC / "mmio.cpp", ["-O2"])))
    except RuntimeError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mm_open.restype = ctypes.c_int64
    lib.mm_open.argtypes = [ctypes.c_char_p]
    lib.mm_info.restype = ctypes.c_int
    lib.mm_info.argtypes = [ctypes.c_int64, i64p, i64p, i64p,
                            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mm_expanded_nnz.restype = ctypes.c_int64
    lib.mm_expanded_nnz.argtypes = [ctypes.c_int64]
    lib.mm_read.restype = ctypes.c_int64
    lib.mm_read.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.POINTER(ctypes.c_double)]
    lib.mm_close.restype = None
    lib.mm_close.argtypes = [ctypes.c_int64]
    _LIB = lib
    return lib


def native_available() -> bool:
    """True when the native parser builds and loads (builds it on the
    first call)."""
    return _load_lib() is not None


def _load_mtx_python(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Pure-Python fallback parser (the JAX package's, line by line)."""
    with open(path) as f:
        header = f.readline().split()
        if len(header) < 5 or header[1] != "matrix" or header[2] != "coordinate":
            raise ValueError(f"unsupported MatrixMarket header in {path}")
        pattern = header[3].lower() == "pattern"
        symmetry = header[4].lower()
        symmetric = symmetry in ("symmetric", "skew-symmetric")
        skew = symmetry == "skew-symmetric"
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, nnz = (int(x) for x in line.split())
        ri, ci, vi = [], [], []
        for _ in range(nnz):
            parts = f.readline().split()
            r, c = int(parts[0]) - 1, int(parts[1]) - 1
            v = 1.0 if pattern else float(parts[2])
            ri.append(r)
            ci.append(c)
            vi.append(v)
            if symmetric and r != c:
                ri.append(c)
                ci.append(r)
                vi.append(-v if skew else v)
    return np.asarray(ri), np.asarray(ci), np.asarray(vi), (rows, cols)


def _fallback(path: str, why: str):
    warnings.warn(f"{why}; parsing {path} with the pure-Python fallback", RuntimeWarning,
                  stacklevel=3)
    return _load_mtx_python(path)


def _refuse_complex(path: str) -> None:
    """Raise ValueError for a ``complex`` field or ``hermitian`` symmetry:
    both parsers read one real value an entry and mirror only symmetric
    and skew-symmetric storage."""
    with open(path) as f:
        header = f.readline().lower().split()
    if "complex" in header[3:4] or "hermitian" in header[4:5]:
        raise ValueError(f"{path}: complex and Hermitian Matrix Market files are not "
                         f"supported (header {' '.join(header)!r})")


def load_mtx(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Read a .mtx file -> (row_idx, col_idx, values, (rows, cols)) COO,
    symmetric storage expanded.  Uses the native parser when available
    and warns when it falls back to Python.  Raises ValueError on a
    complex or Hermitian file."""
    _refuse_complex(path)
    lib = _load_lib()
    if lib is None:
        return _fallback(path, "the native Matrix Market parser did not build")
    h = lib.mm_open(str(path).encode())
    if h < 0:
        return _fallback(path, f"the native parser cannot open it (mm_open {h})")
    try:
        r = ctypes.c_int64()
        c = ctypes.c_int64()
        nz = ctypes.c_int64()
        sym = ctypes.c_int()
        pat = ctypes.c_int()
        lib.mm_info(h, ctypes.byref(r), ctypes.byref(c), ctypes.byref(nz),
                    ctypes.byref(sym), ctypes.byref(pat))
        total = lib.mm_expanded_nnz(h)
        if total < 0:
            raise IOError(f"mm_expanded_nnz failed for {path}")
        ri = np.empty(total, np.int64)
        ci = np.empty(total, np.int64)
        vi = np.empty(total, np.float64)
        got = lib.mm_read(
            h,
            ri.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if got != total:
            raise IOError(f"short read from {path}: {got}/{total}")
        return ri, ci, vi, (r.value, c.value)
    finally:
        lib.mm_close(h)


def load_operator(path: str, dtype=None, dia_max_diags: int = 32, device="cuda"):
    """Load a .mtx matrix as an operator on ``device``: DIA (``dtype``,
    float64 by default) when the sparsity lives on at most
    ``dia_max_diags`` diagonals, ELL otherwise (the file's float64
    values, as in the JAX package)."""
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.ops.formats import dia_from_scipy
    from ca_lanczos_tpu_torch.ops.spmv import EllMatrix

    ri, ci, vi, (rows, cols) = load_mtx(path)
    if rows != cols:
        raise ValueError(f"{path}: operator must be square ({rows}x{cols})")
    coo = sp.coo_matrix((vi, (ri, ci)), shape=(rows, cols))
    np_dtype = np.float64 if dtype is None else torch.empty(0, dtype=dtype).numpy().dtype
    A = dia_from_scipy(coo, max_diags=dia_max_diags, waste_cap=float("inf"), dtype=np_dtype,
                       device=device)
    return A if A is not None else EllMatrix.from_scipy(coo, device=device)


_CHUNK = 1 << 16  # entries formatted per string operation


def save_mtx(path: str, a, symmetric: bool = False) -> None:
    """Write a dense/scipy matrix as .mtx coordinate real: 1-based indices,
    values as ``%.17g``, the lower triangle when ``symmetric``.  The JAX
    package's text byte for byte; each chunk of entries is formatted by
    one ``%`` over a repeated line template, in C."""
    import scipy.sparse as sp

    coo = sp.coo_matrix(a)
    if symmetric:
        mask = coo.row >= coo.col
        rows, cols, vals = coo.row[mask], coo.col[mask], coo.data[mask]
    else:
        rows, cols, vals = coo.row, coo.col, coo.data
    with open(path, "w") as f:
        sym = "symmetric" if symmetric else "general"
        f.write(f"%%MatrixMarket matrix coordinate real {sym}\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {len(vals)}\n")
        for k in range(0, len(vals), _CHUNK):
            sl = slice(k, k + _CHUNK)
            r, c, v = (rows[sl] + 1).tolist(), (cols[sl] + 1).tolist(), vals[sl].tolist()
            args = [None] * (3 * len(v))
            args[0::3], args[1::3], args[2::3] = r, c, v
            f.write("%d %d %.17g\n" * len(v) % tuple(args))
