"""Synthetic operator builders mirroring the reference's test fixtures
(counterpart of ``ca_lanczos_tpu/utils/matrices.py``; inputs are made
with numpy so both packages can be fed identical values).

* ``diag_spectrum`` — diag(linspace(lo, hi, n)): exactly-known spectra
  (test_convergence_diagonal_matrices.m:9-21).
* ``laplacian_1d`` / ``laplacian_2d`` — banded FD Laplacians.
"""

from __future__ import annotations

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix


def diag_spectrum(n: int, lo: float = 1.0, hi: float = 100.0, dtype=torch.float64,
                  device="cuda") -> DiaMatrix:
    """A = diag(linspace(lo, hi, n)); eigenvalues known exactly."""
    d = torch.as_tensor(np.linspace(lo, hi, n), dtype=dtype, device=device)
    return DiaMatrix(data=d[None, :], offsets=(0,))


def laplacian_1d(n: int, dtype=torch.float64, device="cuda") -> DiaMatrix:
    """Standard 3-point 1-D Laplacian (tridiag [-1, 2, -1]), SPD."""
    data = np.zeros((3, n))
    data[0, 1:] = -1.0  # A[i, i-1]
    data[1] = 2.0
    data[2, : n - 1] = -1.0  # A[i, i+1]
    return DiaMatrix(data=torch.as_tensor(data, dtype=dtype, device=device),
                     offsets=(-1, 0, 1))


def laplacian_2d(nx: int, ny: int, dtype=torch.float64, device="cuda") -> DiaMatrix:
    """5-point 2-D Laplacian on an nx-by-ny grid (row-major), SPD; the +/-1
    diagonals are zeroed at grid-row boundaries."""
    n = nx * ny
    i = np.arange(n)
    data = np.stack([
        np.where(i >= nx, -1.0, 0.0),  # A[i, i-nx]
        np.where(i % nx != 0, -1.0, 0.0),  # A[i, i-1]
        np.full(n, 4.0),
        np.where((i + 1) % nx != 0, -1.0, 0.0),  # A[i, i+1]
        np.where(i < n - nx, -1.0, 0.0),  # A[i, i+nx]
    ])
    return DiaMatrix(data=torch.as_tensor(data, dtype=dtype, device=device),
                     offsets=(-nx, -1, 0, 1, nx))
