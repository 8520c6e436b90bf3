"""Structured run records replacing the reference's ad-hoc .out files
(test_restarted_ca_lanczos_all_matrices.m:36-53 writes
'max ritz norm, max orth err, max eig err, restarts, time' per case;
here every case is one JSON line with named fields).

A copy of ``ca_lanczos_tpu/harness/records.py`` (the port keeps its own):
the same fields and JSON, so either package reads the other's files."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class RunRecord:
    """One experiment case: solver configuration + outcome metrics."""

    matrix: str
    solver: str
    s: Optional[int] = None
    basis: Optional[str] = None
    orth: Optional[str] = None
    n_wanted: Optional[int] = None
    max_ritz_norm: Optional[float] = None
    max_orth_err: Optional[float] = None
    max_eig_err: Optional[float] = None
    n_restarts: Optional[int] = None
    converged: Optional[bool] = None
    wall_s: Optional[float] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        d.update(extra)
        return json.dumps({k: v for k, v in d.items() if v is not None})


def write_records(path: str, records: List[RunRecord]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(r.to_json() + "\n")


def read_records(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
