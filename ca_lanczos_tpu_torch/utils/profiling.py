"""Kernel profiling and roofline audit.

Counterpart of ``ca_lanczos_tpu/utils/profiling.py``:

* ``roofline_audit`` — the JAX package's traffic model of one unfused DIA
  matrix-powers step (read every plane and x, write y) and a measured
  rate -> fraction of the memory speed of light.  The default bandwidth is
  the NVIDIA H100 SXM's published 3.35 TB/s (80 GB HBM3, at its 700 W
  power limit); pass ``hbm_bw`` for another card.
* ``measure_powers_throughput`` — nnz/s of a chain of K2 steps
  (``ops.cuda_spmv.dia_power_step``, zero coefficients);
  ``measure_ca_iteration_throughput`` — CA iterations/s of the fused
  serving step: K1 powers (``"roll"``) or K3 on the interleaved carrier
  (``"ilv"``, ``"ilv_rm"``), two-pass block CGS, CholQR2.
* ``trace`` — a ``torch.profiler`` context writing a Chrome trace.

Divergences from the JAX package.  On a CUDA operator the chained work
is timed between two CUDA events (the shortest of ``trials`` runs); the
JAX two-point protocol cancelled a relay latency the card does not have,
so the short chain is only a warm-up.  On the CPU the host clock times
the plain versions.  ``use_pallas`` keeps its name and means "the
hand-written kernel": False runs the kernels' plain PyTorch versions on
any device.  A kernel that fails raises: nothing falls back to the plain
path.  The Mosaic-aligned ``dia_flat_padded`` layout is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_spmv
from ca_lanczos_tpu_torch.ops.qr import _chol_safe, cholqr2
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

# HBM bandwidth, bytes/s: NVIDIA H100 SXM (80 GB HBM3), data sheet, 700 W.
DEFAULT_HBM_BW = 3.35e12


@dataclasses.dataclass
class RooflineReport:
    nnz: int
    bytes_per_step: int
    flops_per_step: int
    arithmetic_intensity: float  # flop / byte
    sol_nnz_per_s: float  # HBM speed-of-light
    measured_nnz_per_s: Optional[float] = None
    fraction_of_peak: Optional[float] = None

    def __str__(self) -> str:
        lines = [
            f"nnz/step            : {self.nnz:,}",
            f"bytes/step          : {self.bytes_per_step:,}",
            f"flops/step          : {self.flops_per_step:,}",
            f"arith intensity     : {self.arithmetic_intensity:.3f} flop/B (HBM-bound)",
            f"speed of light      : {self.sol_nnz_per_s / 1e9:.1f} Gnnz/s",
        ]
        if self.measured_nnz_per_s is not None:
            lines.append(f"measured            : {self.measured_nnz_per_s / 1e9:.1f} Gnnz/s")
            lines.append(f"fraction of peak    : {100 * self.fraction_of_peak:.1f}%")
        return "\n".join(lines)


def roofline_audit(
    A: DiaMatrix,
    measured_nnz_per_s: Optional[float] = None,
    hbm_bw: float = DEFAULT_HBM_BW,
) -> RooflineReport:
    """Traffic model of one DIA matrix-powers step: read all diagonals +
    the vector, write the result; 2 flops per stored element."""
    itemsize = A.data.element_size()
    n = A.n
    ndiags = A.data.shape[0]
    nnz = n * ndiags  # stored elements (incl. structural zeros at edges)
    bytes_per_step = (ndiags * n + 2 * n) * itemsize  # data + x + y
    flops = 2 * nnz + 4 * n  # fma per element + shift/correction terms
    sol = hbm_bw / bytes_per_step * nnz
    rep = RooflineReport(
        nnz=nnz,
        bytes_per_step=bytes_per_step,
        flops_per_step=flops,
        arithmetic_intensity=flops / bytes_per_step,
        sol_nnz_per_s=sol,
    )
    if measured_nnz_per_s is not None:
        rep.measured_nnz_per_s = measured_nnz_per_s
        rep.fraction_of_peak = measured_nnz_per_s / sol
    return rep


def _seconds(fn: Callable[[], None], device: torch.device, trials: int) -> float:
    """Shortest of ``trials`` runs of fn(): between two CUDA events on a
    CUDA device, on the host clock otherwise."""
    ts = []
    for _ in range(trials):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return min(ts)


def cuda_event_ms(fn: Callable[[], object], reps: int = 20, warm: int = 3,
                  batch: int = 10) -> float:
    """Device milliseconds per call of fn(): the median over ``reps`` runs
    of ``batch`` back-to-back calls between two CUDA events, over batch.
    Within a run the host prepares the next call while the card runs the
    last, so only the first call's host work shows (1/batch of it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / batch)
    return float(np.median(ts))


def measure_powers_throughput(
    A: DiaMatrix,
    s: int = 8,
    reps_lo: int = 2,
    reps_hi: int = 12,
    trials: int = 3,
    use_pallas: bool = True,
) -> float:
    """Stored nnz/s of a chain of ``reps_hi * s`` matrix-powers steps from
    a seeded vector: with ``use_pallas`` single K2 steps with zero
    coefficients (the JAX package's ``_dia_power_step`` chain), else
    ``reps_hi`` plain monomial s-step powers (what
    ``matrix_powers_monomial`` computes) fed their last column.  A chain
    of ``reps_lo`` runs first as the warm-up (module docstring)."""
    q = torch.as_tensor(np.random.default_rng(0).standard_normal(A.n), dtype=A.dtype,
                        device=A.device)
    zero = np.zeros(2)

    def chain(reps: int) -> None:
        if use_pallas:
            vp, v = torch.zeros_like(q), q
            for _ in range(reps * s):
                vp, v = v, cuda_spmv.dia_power_step(A.data, v, vp, zero, A.offsets)
        else:
            v = q
            for _ in range(reps):
                _, v = cuda_spmv.dia_powers_fused_ref(A.data, v, None, A.offsets, s)

    chain(reps_lo)
    t = _seconds(lambda: chain(reps_hi), A.device, trials)
    return A.n * A.data.shape[0] * s * reps_hi / t


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the region (the card too when there is one);
    writes a Chrome trace ``trace.<time>.json`` into ``logdir`` on exit
    and yields the profiler (``key_averages()`` for tables)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace.{time.strftime('%Y%m%d-%H%M%S')}.json"))


def _ca_body(powers, Qp: torch.Tensor) -> torch.Tensor:
    """One fused CA iteration on an (n, s+1) carry block: powers from its
    last column, two-pass CGS against the carry, CholQR2."""
    V = powers(Qp[:, -1])
    X = V[:, 1:]
    for _ in range(2):
        X = X - Qp @ (Qp.T @ X)
    Qn, _ = cholqr2(X)
    return torch.cat([Qp[:, -1:], Qn], dim=1)


def _ca_body_rm(powers_rm, Qp: torch.Tensor) -> torch.Tensor:
    """Row-major (s+1, n) form of :func:`_ca_body`: the powers kernel's
    native (s, n) output chains straight into row-major CGS/CholQR (no
    transpose per block); Q = L^-1 X per CholQR pass, solved as (X^T
    L^-T)^T: torch's left triangular solve of a wide row-major X is
    thousands of times slower on the card than this right solve of its
    transposed view (chip_smoke's phase I reads the chain's rate)."""
    X = powers_rm(Qp[-1])
    for _ in range(2):
        X = X - (X @ Qp.T) @ Qp
    for _ in range(2):
        L = _chol_safe(X @ X.T)
        X = torch.linalg.solve_triangular(L.mT, X.mT, upper=True, left=False).mT
    return torch.cat([Qp[-1:], X], dim=0)


def _ca_chain(A: DiaMatrix, s: int, kernel: str, use_pallas: bool):
    """(Q0, step) of a fused CA chain: the seeded orthonormal carry block
    in the kernel's layout and space ((n, s+1), or (s+1, n) for
    "ilv_rm"), and one iteration Qp -> Qp'."""
    if kernel not in ("roll", "ilv", "ilv_rm"):
        raise ValueError(f"unknown kernel {kernel!r}")
    rng = np.random.default_rng(0)
    Q0 = np.linalg.qr(rng.standard_normal((A.n, s + 1)))[0]
    zeros = np.zeros((s, 2))
    if kernel == "roll":
        powers_fn = cuda_spmv.dia_powers_fused if use_pallas else cuda_spmv.dia_powers_fused_ref
        data = A.data
    else:
        powers_fn = cuda_ilv.dia_powers_ilv if use_pallas else cuda_ilv.dia_powers_ilv_ref
        data = cuda_ilv.IlvDiaMatrix.from_dia(A, keep_dia=False).data_il
        Q0 = cuda_ilv.ilv_encode(Q0)
    if kernel == "ilv_rm":
        Q0 = Q0.T

    def powers(q):
        V, _ = powers_fn(data, q.contiguous(), zeros, A.offsets, s)
        return V if kernel == "ilv_rm" else torch.cat([q[:, None], V.T], dim=1)

    body = _ca_body_rm if kernel == "ilv_rm" else _ca_body
    Q0 = torch.as_tensor(np.ascontiguousarray(Q0), dtype=A.dtype, device=A.device)
    return Q0, lambda Qp: body(powers, Qp)


def measure_ca_iteration_throughput(
    A: DiaMatrix,
    s: int = 8,
    blocks_lo: int = 2,
    blocks_hi: int = 10,
    trials: int = 3,
    use_pallas: bool = True,
    kernel: str = "roll",
) -> float:
    """CA-Lanczos iterations/second (one iteration = s SpMVs + block orth)
    of ``blocks_hi`` chained fused iterations — the 'iters/sec vs s'
    north-star metric (BASELINE.md).  kernel: "roll" (K1 powers, the JAX
    package's round-1/2 fused layout), "ilv" (K3 on the interleaved
    carrier, the state chained in the permuted space) or "ilv_rm" (K3 and
    a row-major basis: no per-block transpose).  ``use_pallas=False``
    runs the kernels' plain versions; timing as the module docstring."""
    Q0, step = _ca_chain(A, s, kernel, use_pallas)

    def chain(blocks: int) -> None:
        Qp = Q0
        for _ in range(blocks):
            Qp = step(Qp)

    chain(blocks_lo)
    return blocks_hi / _seconds(lambda: chain(blocks_hi), A.device, trials)
