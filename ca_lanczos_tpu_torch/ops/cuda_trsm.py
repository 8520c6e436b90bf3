"""Tall-skinny right triangular solve Y = X R^{-1}: wrapper, plain version.

The kernel is CUDA C++ in ``csrc/tall_trsm.cu`` (see its header for what
it replaces and what bounds it).  It takes a real float32/float64 (n, k)
block X with 1 <= k <= ``MAX_K`` in either layout the solvers hand over:
row-major (``X.stride(1) == 1``, row stride >= k, column slices included)
or column-major (``X.stride(0) == 1``, the transposed view of a (k, n)
basis), and an upper-triangular (k, k) R of X's dtype and device with any
strides; only R's upper triangle is read.  It returns a new contiguous
(n, k) Y.

``tall_trsm`` takes the plain version ``tall_trsm_ref`` only for CPU
tensors.  For CUDA tensors it launches the kernel or raises; it never
casts.  ``LAUNCHES`` counts kernel launches.  ``ops.qr._rsolve`` sends here
the blocks on the card that :func:`fits`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ca_lanczos_tpu_torch.ops._cuda_build import load

MAX_K = 64
DTYPES = (torch.float32, torch.float64)
LAUNCHES = {"tall_trsm": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGS = {f"tall_trsm_{t}": ([_P, _L, _I, _P, _L, _L, _P, _L, _I, _P], _I) for t in ("f32", "f64")}


def _lib():
    return load("tall_trsm", _SIGS)


def layout(X: torch.Tensor) -> Optional[Tuple[bool, int]]:
    """(column-major?, leading dimension) of an (n, k) block as the kernel
    reads it, or None when its strides are neither of its two layouts."""
    n, k = X.shape
    s0, s1 = X.stride()
    if s1 == 1 or k == 1:
        if n == 1:
            return False, k
        if s0 >= k:
            return False, s0
    if s0 == 1 and s1 >= n:
        return True, s1
    return None


def fits(X: torch.Tensor) -> bool:
    """Whether the kernel takes the block X, wherever it lies: a real
    float32/float64 (n, k) block, 1 <= k <= MAX_K, in one of its two
    layouts."""
    return (X.dtype in DTYPES and X.dim() == 2 and 1 <= X.shape[1] <= MAX_K
            and layout(X) is not None)


def tall_trsm_ref(X: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Plain version: X R^{-1} by the kernel's substitution, column by
    column, y_j = (x_j - sum_{i<j} y_i R_ij) / R_jj; reads only R's upper
    triangle."""
    Y = torch.empty(X.shape, dtype=X.dtype, device=X.device)
    for j in range(X.shape[1]):
        Y[:, j] = (X[:, j] - Y[:, :j] @ R[:j, j]) / R[j, j]
    return Y


def tall_trsm(X: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """X R^{-1} for an upper-triangular R (see the module docstring)."""
    if X.dim() != 2 or R.shape != (X.shape[1], X.shape[1]):
        raise ValueError(f"expected X (n, k) and R (k, k), got {tuple(X.shape)} and "
                         f"{tuple(R.shape)}")
    if R.dtype != X.dtype:
        raise TypeError(f"R's dtype {R.dtype} differs from X's {X.dtype}")
    if R.device != X.device:
        raise ValueError(f"mixed devices {X.device} and {R.device}")
    if X.device.type == "cpu":
        return tall_trsm_ref(X, R)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if not fits(X):
        raise ValueError(f"the kernel takes a real float32/float64 (n, k) block, 1 <= k <= "
                         f"{MAX_K}, row- or column-major; got {X.dtype} {tuple(X.shape)} "
                         f"strides {X.stride()}")
    n, k = X.shape
    cols, ld = layout(X)
    Y = torch.empty((n, k), dtype=X.dtype, device=X.device)
    if n == 0:
        return Y
    fn = getattr(_lib(), "tall_trsm_f32" if X.dtype == torch.float32 else "tall_trsm_f64")
    with torch.cuda.device(X.device):
        rc = fn(X.data_ptr(), ld, int(cols), R.data_ptr(), R.stride(0), R.stride(1),
                Y.data_ptr(), n, k, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tall_trsm launch failed: CUDA error {rc}")
    LAUNCHES["tall_trsm"] += 1
    return Y
