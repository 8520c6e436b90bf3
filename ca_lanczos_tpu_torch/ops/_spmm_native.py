"""ctypes binding to the host's row-parallel CSR SpMM (``csrc/host_spmm.cpp``).

Counterpart of ``ca_lanczos_tpu/ops/_spmm_native.py``.  ``CsrMatmul(a)(X)``
is ``a @ X`` for a scipy CSR ``a`` and a dense f64 ``X`` of shape (n,) or
(n, k), OpenMP over rows on ``torch.get_num_threads()`` threads: the apply
of the host polish (``solvers.polish.f64_operator``), where scipy's product
runs on one thread.  Each entry is summed in scipy's order, so the result
equals scipy's ``a @ X`` bit for bit.

The library is built from the port's own source by
``utils._native_build`` (``g++ -O3 -fopenmp -ffp-contract=off``) into
``build/native/`` at first use, never at import.

Divergences from the JAX package: every column is computed for any k
(its C function keeps the first 64, so its wrapper sends k > 64 to
scipy); a library that does not build raises with the compiler's message
(its wrapper falls back to scipy); the caller's matrix is neither
re-sorted nor modified.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.utils._native_build import build_native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_spmm.cpp"
FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off")
APPLIES = {"csr_spmm_host": 0}  # one per CsrMatmul call

_LIB: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """Build (once per process) and bind the library; raises RuntimeError
    with the compiler's message when it does not build."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_native(SOURCE, FLAGS)))
        lib.csr_spmm_f64.restype = None
        lib.csr_spmm_f64.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int,
        ]
        _LIB = lib
    return _LIB


def available() -> bool:
    """True when the library builds and loads (builds it on the first call)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


class CsrMatmul:
    """Reusable ``a @ X`` for one real scipy sparse matrix (keeps the
    int64 / int32 / f64 arrays the C ABI takes)."""

    def __init__(self, a):
        import scipy.sparse as sp

        csr = sp.csr_matrix(a)
        if np.iscomplexobj(csr.data):
            raise TypeError("CsrMatmul takes a real matrix")
        if csr.shape[1] >= 2**31:
            raise ValueError(f"{csr.shape[1]} columns do not fit the int32 indices")
        self.shape = csr.shape
        self._indptr = np.ascontiguousarray(csr.indptr, np.int64)
        self._indices = np.ascontiguousarray(csr.indices, np.int32)
        self._data = np.ascontiguousarray(csr.data, np.float64)
        self._lib = _load()

    def __call__(self, X: np.ndarray) -> np.ndarray:
        if np.iscomplexobj(X):
            raise TypeError("CsrMatmul takes a real X")
        X = np.ascontiguousarray(X, np.float64)
        one = X.ndim == 1
        if one:
            X = X[:, None]
        if X.ndim != 2 or X.shape[0] != self.shape[1]:
            raise ValueError(f"X of shape {X.shape} for a {self.shape} matrix")
        k = X.shape[1]
        Y = np.empty((self.shape[0], k), np.float64)
        self._lib.csr_spmm_f64(self.shape[0], self._indptr, self._indices, self._data, X, k,
                               Y, torch.get_num_threads())
        APPLIES["csr_spmm_host"] += 1
        return Y[:, 0] if one else Y
