"""Headline benchmark of the port: SpMV throughput (nnz/s) inside the
fused CA-Lanczos matrix-powers kernel K1 on one CUDA card.

Run from the root of a checkout:  ``python -m ca_lanczos_tpu_torch.bench``

Counterpart of the JAX package's ``bench.py`` on its operator (4,194,304
rows x 9 diagonals, float32, spectral norm ~1, s = 8, seed 0).  The
s-step powers run through K1 (``ops.cuda_spmv.dia_powers_fused``,
monomial), each call fed the last power of the one before, and a chain
of ``reps`` calls is timed between two CUDA events.  Each estimate is
the two-point difference of a 220-call and a 20-call chain (the shortest
of 3 runs each); the value is the median of 5 estimates, the spread their
minimum and maximum.  There is no fallback: without a CUDA card, or if
K1 fails, the script exits with an error.

Prints the card's name and power limit (nvidia-smi) on one line, then ONE
JSON line with the JAX bench's keys: {"metric", "value", "unit",
"vs_baseline", "spread_min", "spread_max", "trials", "path"}.
``vs_baseline`` is null: no H100 baseline has been recorded (the repo's
BENCH_BEST.json holds a TPU value).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

N = 1 << 22
OFFSETS = tuple(range(-4, 5))
S = 8
REPS_LO, REPS_HI = 20, 220


def bench_operator():
    """The JAX bench's planes (9, N) float32 and unit start vector, drawn
    in its order from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    data = np.asarray(rng.standard_normal((len(OFFSETS), N)), np.float32) * 0.02
    data[len(OFFSETS) // 2] += 0.8
    q = np.asarray(rng.standard_normal(N), np.float32)
    q /= np.linalg.norm(q)
    return data, q


def main() -> int:
    if not torch.cuda.is_available():
        print("ca_lanczos_tpu_torch.bench: no CUDA device visible; the benchmark "
              "measures the card", file=sys.stderr)
        return 2
    from ca_lanczos_tpu_torch.ops.cuda_spmv import dia_powers_fused
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
    from ca_lanczos_tpu_torch.utils.profiling import _seconds

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    data, q = bench_operator()
    A = DiaMatrix(data=torch.as_tensor(data, device="cuda"), offsets=OFFSETS)
    q0 = torch.as_tensor(q, device="cuda")

    def chain(reps: int) -> None:
        v = q0
        for _ in range(reps):
            _, v = dia_powers_fused(A.data, v, None, A.offsets, S)

    def timed(reps: int) -> float:
        return _seconds(lambda: chain(reps), A.device, trials=3)

    chain(REPS_HI)  # warm-up: builds and loads the kernel
    torch.cuda.synchronize()
    estimates = sorted(A.nnz * S * (REPS_HI - REPS_LO) / (timed(REPS_HI) - timed(REPS_LO)) / 1e9
                       for _ in range(5))
    print(json.dumps({
        "metric": "matrix_powers_spmv_throughput",
        "value": round(estimates[len(estimates) // 2], 4),
        "unit": "Gnnz/s/chip",
        "vs_baseline": None,
        "spread_min": round(estimates[0], 1),
        "spread_max": round(estimates[-1], 1),
        "trials": len(estimates),
        "path": "cuda-dia-fused",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
