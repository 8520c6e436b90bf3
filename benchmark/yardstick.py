"""The frozen arithmetic that the metric readers share: the table of
peaks, the facts of the benchmark's own matrix, the least time for a
kernel's work, and means over a window's solves."""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peaks_for(kind: str) -> Optional[dict]:
    """The published peaks of the device named ``kind``, or None."""
    return PEAKS.get(kind)


@dataclasses.dataclass(frozen=True)
class MatrixFacts:
    n: int
    nnz: int
    diagonals: int  # occupied diagonals


def matrix_facts(a) -> MatrixFacts:
    """Counted from the matrix the benchmark built (a scipy CSR)."""
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
    off = a.indices.astype(np.int64) - rows
    diagonals = int(np.count_nonzero(np.bincount(off - off.min()))) if off.size else 0
    return MatrixFacts(n=n, nnz=int(a.nnz), diagonals=diagonals)


def matrix_bytes(m: MatrixFacts, itemsize: int) -> int:
    """The matrix read once: the fewer of its DIA planes or its CSR arrays
    (values, 4-byte column indices, 4-byte row pointers)."""
    return min(m.diagonals * m.n * itemsize, m.nnz * (itemsize + 4) + (m.n + 1) * 4)


def bound_seconds(nbytes: float, flops: float, dtype: str, peaks: dict) -> float:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate of ``dtype``, the larger."""
    return max(nbytes / peaks["bytes_per_s"], flops / peaks["flops_per_s"][dtype])


def roofline(run, patterns: Sequence[str], dtype: str,
             call_bytes: Callable[[MatrixFacts], float],
             call_flops: Callable[[MatrixFacts], float]) -> Optional[float]:
    """Share (%) of the least time in the device time of the launches whose
    names match ``patterns``: launches x the per-call bound over their
    summed time.  None where nothing matched or the peaks are unknown."""
    if run.device_ops is None or run.peaks is None or run.matrix is None:
        return None
    rx = [re.compile(p) for p in patterns]
    times = [e - s for n, s, e in run.device_ops if any(r.search(n) for r in rx)]
    if not times or sum(times) <= 0:
        return None
    per_call = bound_seconds(call_bytes(run.matrix), call_flops(run.matrix), dtype, run.peaks)
    return 100.0 * len(times) * per_call / sum(times)


def mean_stage(run, key: str) -> Optional[float]:
    """Mean over the window's solves of one ``stage_seconds`` entry (the
    sum over all solves divided by their count); None where no solve
    has the stage."""
    vals = [s["stage_seconds"][key] for s in run.solves if key in s["stage_seconds"]]
    if not vals or len(vals) != len(run.solves):
        return None
    return sum(vals) / len(vals)
