"""Checkpoint / resume for the restarted drivers.

A copy of ``ca_lanczos_tpu/utils/checkpoint.py`` (numpy only), so that a
checkpoint written by either package resumes in the other.  The natural
checkpoint granularity is the restart boundary (restarted_ca_lanczos.m:
73-80,170-172); ``RestartCheckpoint`` serializes exactly that state, and
``solvers.restarted.restarted_ca_lanczos`` accepts ``checkpoint_path``
(write per restart) and ``resume_from`` (continue a run).

Divergence: the JAX package also reads its round-3 checkpoints, which
pickled the RNG state; this copy reads only the JSON form both packages
write, and never unpickles.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RestartCheckpoint:
    """Restart-boundary state of restarted_ca_lanczos."""

    n_restarts: int
    nconv: int
    conv_eigs: List[float]
    conv_rnorms: List[float]
    orth_err: List[float]
    rnorm_rows: List[np.ndarray]
    Q_conv: Optional[np.ndarray]  # (n, nconv) or None
    q: np.ndarray  # next start vector
    Bk: np.ndarray
    rng_state: dict

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        np.savez_compressed(
            tmp,
            n_restarts=self.n_restarts,
            nconv=self.nconv,
            conv_eigs=np.asarray(self.conv_eigs),
            conv_rnorms=np.asarray(self.conv_rnorms),
            orth_err=np.asarray(self.orth_err),
            rnorm_rows=np.asarray(self.rnorm_rows) if self.rnorm_rows else np.zeros((0, 0)),
            Q_conv=self.Q_conv if self.Q_conv is not None else np.zeros((0, 0)),
            q=self.q,
            Bk=self.Bk,
            # JSON bytes, not a pickled object array; PCG64 state ints
            # exceed 64 bits, which JSON carries.
            rng_state=np.frombuffer(
                json.dumps(self.rng_state, default=int).encode(), np.uint8
            ),
        )
        # np.savez appends .npz to the tmp name.
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)

    @staticmethod
    def load(path: str) -> "RestartCheckpoint":
        z = np.load(path)
        state = json.loads(bytes(z["rng_state"]).decode())
        Q_conv = z["Q_conv"]
        rows = z["rnorm_rows"]
        return RestartCheckpoint(
            n_restarts=int(z["n_restarts"]),
            nconv=int(z["nconv"]),
            conv_eigs=list(z["conv_eigs"]),
            conv_rnorms=list(z["conv_rnorms"]),
            orth_err=list(z["orth_err"]),
            rnorm_rows=[r for r in rows] if rows.size else [],
            Q_conv=Q_conv if Q_conv.size else None,
            q=z["q"],
            Bk=z["Bk"],
            rng_state=state,
        )
