"""Row-sharded ELL operator with halo exchange, for general sparsity.

Counterpart of ``ca_lanczos_tpu/parallel/dist_ell.py``.  Rows are split
in contiguous blocks as for ``DistDia``; each rank holds its ELL rows
PLUS the matrix rows of the s-hop ghost region, with column indices
rebased to the local padded window ``[lo - halo, lo + n_local + halo)``.
The ghost depth is ``halo = s_max * bw`` with ``bw = max |col - row|``
over the structural nonzeros (in ring distance when periodic): matrices
of unbounded bandwidth are RCM-reordered first (``parallel.auto``).

The matrix powers pay one halo exchange per s local gather products, as
on the DIA path.  The local product is plain PyTorch (a gather and a row
sum), as the JAX package's is an XLA gather: no hand kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.spmv import EllMatrix
from ca_lanczos_tpu_torch.parallel.distributed import (
    RowState,
    _coefs,
    _halo_exchange,
    check_s_bound,
)
from ca_lanczos_tpu_torch.parallel.mesh import Mesh


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def ell_shard_planes(A: EllMatrix, P_: int, s_max: int, periodic: bool = False,
                     ranks: Optional[Sequence[int]] = None):
    """Host partition of an ELL operator into per-shard padded windows:
    (vals (R, m, k), cols (R, m, k) window-local, halo, n) as numpy for
    the shards ``ranks`` (default all P_, so R = P_), m = n_local +
    2*halo.  Shared by DistEll and DistPell (which encodes each window).

    The JAX package's partition, computed a window at a time: window row
    j of shard p is global row ``p*n_local - halo + j`` (zero outside [0,
    n), or wrapped mod n when periodic); columns are rebased to the
    window, and structural zeros and columns outside the window are
    masked to value 0 / index 0."""
    vals, cols = _np(A.vals), _np(A.cols).astype(np.int64, copy=False)
    n, kk = vals.shape
    # Effective bandwidth over structural nonzeros.
    dist = cols - np.arange(n)[:, None]
    np.abs(dist, out=dist)
    if periodic:
        np.minimum(dist, n - dist, out=dist)
    dist[vals == 0] = 0
    bw = max(int(dist.max()) if n else 0, 1)
    del dist
    n_local = -(-n // P_)
    n_pad = n_local * P_
    halo = s_max * bw
    if halo >= n_local:
        raise ValueError(
            f"halo {halo} (s_max={s_max} x bandwidth {bw}) >= rows/shard "
            f"{n_local}: reduce bandwidth (e.g. RCM reorder) or lower s"
        )
    if periodic:
        if n_pad != n:
            raise ValueError(f"periodic operator: n={n} must divide evenly over {P_} shards")
        if P_ > 1 and n_local + 2 * halo > n:
            raise ValueError("periodic window exceeds the ring: increase rows/device")
    m = n_local + 2 * halo
    sv, sc = [], []
    for p in (range(P_) if ranks is None else ranks):
        base = p * n_local - halo  # global row of window row 0
        if periodic:
            rows = np.mod(base + np.arange(m), n)
            v, c = vals.take(rows, axis=0), cols.take(rows, axis=0)
            c -= base
            np.mod(c, n, out=c)
        else:
            lo, hi = max(base, 0), min(base + m, n)
            v = np.zeros((m, kk), vals.dtype)
            c = np.zeros((m, kk), np.int64)
            v[lo - base:hi - base] = vals[lo:hi]
            c[lo - base:hi - base] = cols[lo:hi]
            c -= base
        invalid = (v == 0) | (c < 0) | (c >= m)
        v[invalid] = 0
        c[invalid] = 0
        sv.append(v)
        sc.append(c)
    return np.stack(sv), np.stack(sc), halo, n


@dataclasses.dataclass(frozen=True, eq=False)
class DistEll(RowState):
    """This rank's block of a row-sharded ELL operator with an s-deep
    matrix halo.

    vals / cols: (n_local + 2*halo, k) padded ELL rows; cols are LOCAL
    indices into the padded vector window (padding entries: value 0,
    index 0).  ``s_max`` is the partition-time bound on s (0: unchecked).
    """

    vals: torch.Tensor
    cols: torch.Tensor
    halo: int
    n: int
    mesh: Mesh
    periodic: bool = False
    s_max: int = 0
    _casts: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_local(self) -> int:
        return self.vals.shape[0] - 2 * self.halo

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def planes(self, dtype: torch.dtype) -> torch.Tensor:
        """``vals`` in ``dtype`` (kept after the first cast): wider state
        multiplies in its own precision, as the JAX package's promotion
        of f32 values by an f64 vector does."""
        return self._cast(self.vals, dtype)

    @staticmethod
    def from_ell(A: EllMatrix, mesh: Mesh, s_max: int, periodic: bool = False) -> "DistEll":
        """This rank's window of ``A`` on ``mesh.device``.  ``periodic=True``
        measures bandwidth in ring distance and rebases the wrap columns
        into the ghost regions, which the ring exchange fills from the
        opposite end (runLanczos.m:15-18's wrap)."""
        sv, sc, halo, n = ell_shard_planes(A, mesh.size, s_max, periodic, ranks=[mesh.rank])
        return DistEll(vals=torch.from_numpy(sv[0]).to(mesh.device),
                       cols=torch.from_numpy(sc[0]).to(mesh.device), halo=halo, n=n,
                       mesh=mesh, periodic=periodic, s_max=s_max)

    def matvec_padded(self, xp: torch.Tensor) -> torch.Tensor:
        """The window product on a padded vector (m,) or multivector (m, c)."""
        vals = self.planes(xp.dtype)
        if xp.ndim == 1:
            return (vals * xp[self.cols]).sum(dim=1)
        return (vals[..., None] * xp[self.cols]).sum(dim=1)


def _ell_powers_local(A: DistEll, x_local: torch.Tensor, coefs: np.ndarray, s: int,
                      mesh: Mesh, include_q: bool = True) -> torch.Tensor:
    """One halo exchange + s local gather steps of ``w = A v - c0 v - c1
    v_prev`` on the padded vector.  Returns rows: (s+1, n_local) with x
    first, or (s, n_local) with ``include_q=False``."""
    x_local = x_local.contiguous()
    xp = _halo_exchange(x_local, A.halo, mesh, A.periodic)
    V = xp.new_empty((s, xp.shape[0]))
    prev, cur = torch.zeros_like(xp), xp
    for k in range(s):
        V[k] = A.matvec_padded(cur) - float(coefs[k, 0]) * cur - float(coefs[k, 1]) * prev
        prev, cur = cur, V[k]
    center = V[:, A.halo:A.halo + x_local.shape[0]]
    if not include_q:
        return center
    return torch.cat([x_local[None, :], center], dim=0)


def dist_ell_matrix_powers(A: DistEll, x: torch.Tensor, s: int, diag, sub,
                           mesh: Mesh) -> torch.Tensor:
    """This rank's (n_local, s+1) block of [x, p_1(A)x, ..., p_s(A)x] for
    general ELL sparsity (``diag``/``sub`` zeros: monomial).  A transposed
    view of contiguous rows."""
    check_s_bound(A, s)
    return _ell_powers_local(A, x, _coefs(diag, sub, s), s, mesh).T
