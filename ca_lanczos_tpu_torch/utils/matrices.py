"""Synthetic operator builders mirroring the reference's test fixtures
(counterpart of ``ca_lanczos_tpu/utils/matrices.py``; inputs are made
with numpy so both packages can be fed identical values).

* ``diag_spectrum`` — diag(linspace(lo, hi, n)): exactly-known spectra
  (test_convergence_diagonal_matrices.m:9-21).
* ``laplacian_1d`` / ``laplacian_2d`` — banded FD Laplacians.
* ``harmonic_oscillator`` — the 1-D quantum harmonic oscillator
  Hamiltonian with 4th-order periodic finite differences
  (runLanczos.m:15-18), used by the propagation experiments.
* ``gaussian_packet`` — the displaced Gaussian wave packet
  (runLanczos.m:20-21).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, EllMatrix


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


def harmonic_oscillator(
    n: int = 512,
    x_range: Tuple[float, float] = (-10.0, 10.0),
    dtype=torch.float64,
    device="cuda",
) -> Tuple[EllMatrix, np.ndarray]:
    """H = -(1/2) d2/dx2 (4th-order periodic FD) + x^2/2, built as
    runLanczos.m:7-18: off-diagonals 4/3 (distance 1) and -1/12 (distance
    2) with periodic wrap, main diagonal -5/2, scaled by -1/(2 h^2), plus
    the potential 0.5 x^2.  Returns (H as ELL, x grid); the uniform 5
    nonzeros per row map onto ELL, the wrap keeps it out of a narrow band.
    """
    lo, hi = x_range
    h = (hi - lo) / n
    x = lo + h / 2 + h * np.arange(n)
    c1, c2, c0 = 4.0 / 3.0, -1.0 / 12.0, -5.0 / 2.0
    scale = -1.0 / (2.0 * h * h)
    i = np.arange(n)
    cols = np.stack([(i - 2) % n, (i - 1) % n, i, (i + 1) % n, (i + 2) % n], axis=1)
    vals = np.stack([
        np.full(n, scale * c2),
        np.full(n, scale * c1),
        scale * c0 + 0.5 * x**2,
        np.full(n, scale * c1),
        np.full(n, scale * c2),
    ], axis=1)
    H = EllMatrix(vals=torch.as_tensor(vals, dtype=dtype, device=device),
                  cols=torch.as_tensor(cols, dtype=torch.int64, device=device))
    return H, x


def gaussian_packet(x: np.ndarray, width: float = 0.5, displacement: float = 4.0) -> np.ndarray:
    """psi = (1/(pi w^2))^(1/4) exp(-((x - d)/w)^2 / 2) (runLanczos.m:20-21)."""
    return (1.0 / (np.pi * width**2)) ** 0.25 * np.exp(-0.5 * ((x - displacement) / width) ** 2)
