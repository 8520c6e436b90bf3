"""Carry an operator of the JAX package across to the port.

``operator_from_numpy`` reads a JAX operator's leaves through
``np.asarray`` (no ``jax`` import) and builds the port's operator with the
same values on ``device``, so both packages compute on identical
operators.  Recognised by their fields:

* ``PellMatrix`` — ``span_row`` and the other planes and statics, taken
  as they are (the two packages' planes are the same bits);
* ``IlvDiaMatrix`` — ``dia_data``, ``offsets``, ``n_rows``; rebuilt in the
  port's interleaved layout (needs the normal-layout companion, i.e. a
  carrier made with ``keep_dia=True``);
* ``DiaMatrix`` — ``data``, ``offsets``;
* ``DenseMatrix`` — ``a``;
* ``BsrMatrix`` — ``vals`` (4-D tiles), ``cols``; tested before ELL, whose
  fields it shares;
* ``EllMatrix`` — ``vals`` (2-D), ``cols``.

``dist_dia_from_numpy`` does the same for a distributed ``DistDia``: it
builds this rank's block of the port's ``parallel.DistDia`` from the JAX
operator's per-shard planes; ``dist_operator_from_numpy`` for any of the
JAX package's distributed operators (``DistDia``, ``DistEll``,
``DistPell``, ``DistBsr``), so that a test feeds JAX's own partition to
the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
from ca_lanczos_tpu_torch.ops.cuda_ilv import IlvDiaMatrix
from ca_lanczos_tpu_torch.ops.pell import PellMatrix
from ca_lanczos_tpu_torch.ops.spmv import DenseMatrix, DiaMatrix, EllMatrix


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.array(x), dtype=dtype, device=device)


def operator_from_numpy(A, device="cuda"):
    """The port's counterpart of the JAX operator ``A`` (see module doc)."""
    if hasattr(A, "span_row"):
        return PellMatrix(
            vals=_t(A.vals, device), lidx=_t(A.lidx, device), cbase=_t(A.cbase, device),
            span_row=_t(A.span_row, device), n=int(A.n), tile=int(A.tile),
            k_slots=int(A.k_slots), sw=int(A.sw), nnz_count=int(A.nnz_count),
            n_win=int(A.n_win), enc=str(A.enc),
        )
    if hasattr(A, "dia_data") and hasattr(A, "n_rows"):
        if A.dia_data is None:
            raise ValueError("IlvDiaMatrix without dia_data: build it with keep_dia=True")
        dia = DiaMatrix(data=_t(A.dia_data, device), offsets=tuple(int(o) for o in A.offsets))
        if dia.n != int(A.n_rows):
            raise ValueError(f"dia_data has {dia.n} rows, n_rows={A.n_rows}")
        return IlvDiaMatrix.from_dia(dia, keep_dia=True)
    if hasattr(A, "data") and hasattr(A, "offsets"):
        return DiaMatrix(data=_t(A.data, device), offsets=tuple(int(o) for o in A.offsets))
    if hasattr(A, "vals") and hasattr(A, "cols") and np.ndim(A.vals) == 4:
        return BsrMatrix(vals=_t(A.vals, device), cols=_t(A.cols, device, torch.int64))
    if hasattr(A, "vals") and hasattr(A, "cols"):
        return EllMatrix(vals=_t(A.vals, device), cols=_t(A.cols, device, torch.int64))
    if hasattr(A, "a"):
        return DenseMatrix(a=_t(A.a, device))
    raise TypeError(f"no port counterpart for {type(A).__name__}")


def dist_dia_from_numpy(A, mesh, ilv: bool = False):
    """This rank's ``parallel.DistDia`` from a JAX ``DistDia``'s arrays:
    ``data[p]`` (p = ``mesh.rank``) becomes the rank's (nd, n_local +
    2*halo) planes; ``offsets``, ``halo``, ``n`` and ``periodic`` carry
    over.  ``ilv=True`` rebuilds the interleaved planes of the rank's
    padded domain from the shards' natural rows (the JAX package's
    tile-major planes are a TPU layout and are not read)."""
    from ca_lanczos_tpu_torch.parallel.distributed import DistDia, _ilv_planes

    data = np.asarray(A.data)
    P, _, m = data.shape
    if P != mesh.size:
        raise ValueError(f"operator has {P} shards, the mesh {mesh.size} ranks")
    halo, n, periodic = int(A.halo), int(A.n), bool(A.periodic)
    offsets = tuple(int(o) for o in A.offsets)
    n_local = m - 2 * halo
    p = mesh.rank
    ilv_data, m_pad = None, 0
    if ilv:
        s_max = halo // max(max((abs(o) for o in offsets), default=1), 1)
        rows = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([data[q, :, halo:halo + n_local] for q in range(P)], axis=1)[:, :n]))
        ilv_data, m_pad = _ilv_planes(rows, offsets, n_local, s_max, p, periodic, mesh.device)
    return DistDia(data=torch.from_numpy(np.ascontiguousarray(data[p])).to(mesh.device),
                   offsets=offsets, halo=halo, n=n, mesh=mesh, periodic=periodic,
                   ilv_data=ilv_data, ilv_m_pad=m_pad)


def dist_operator_from_numpy(A, mesh, ilv: bool = False):
    """This rank's port operator from a JAX distributed operator's stacked
    per-shard planes (shard p = ``mesh.rank``), recognised by its fields:

    * ``DistPell`` (``span_row``) — the shard's planes as a unit-encoded
      ``PellMatrix`` of the (m x m) window (the JAX package pads every
      shard to common statics: zero-valued no-op slots, kept as they are);
    * ``DistBsr`` (``halo_b``) — the shard's tiles and local block columns;
    * ``DistEll`` (``vals``, ``cols``) — the shard's ELL window;
    * ``DistDia`` (``data``) — :func:`dist_dia_from_numpy`."""
    from ca_lanczos_tpu_torch.parallel.dist_bsr import DistBsr
    from ca_lanczos_tpu_torch.parallel.dist_ell import DistEll
    from ca_lanczos_tpu_torch.parallel.dist_pell import DistPell

    if hasattr(A, "data") and hasattr(A, "offsets"):
        return dist_dia_from_numpy(A, mesh, ilv=ilv)
    P, p, dev = np.shape(A.vals)[0], mesh.rank, mesh.device
    if P != mesh.size:
        raise ValueError(f"operator has {P} shards, the mesh {mesh.size} ranks")
    s_max = int(getattr(A, "s_max", 0))
    if hasattr(A, "span_row"):
        vals = np.asarray(A.vals)[p]
        W = PellMatrix(vals=_t(vals, dev), lidx=_t(np.asarray(A.lidx)[p], dev),
                       cbase=_t(np.asarray(A.cbase)[p], dev),
                       span_row=_t(np.asarray(A.span_row)[p], dev), n=int(A.m),
                       tile=int(A.tile), k_slots=int(A.k_slots), sw=int(A.sw),
                       nnz_count=int(np.count_nonzero(vals)), n_win=int(A.n_win), enc="unit")
        return DistPell(A=W, halo=int(A.halo), n=int(A.n), mesh=mesh,
                        periodic=bool(A.periodic), s_max=s_max)
    vals, cols = _t(np.asarray(A.vals)[p], dev), _t(np.asarray(A.cols)[p], dev, torch.int64)
    if hasattr(A, "halo_b"):
        return DistBsr(vals=vals, cols=cols, halo_b=int(A.halo_b), n=int(A.n), mesh=mesh,
                       s_max=s_max)
    return DistEll(vals=vals, cols=cols, halo=int(A.halo), n=int(A.n), mesh=mesh,
                   periodic=bool(A.periodic), s_max=s_max)
