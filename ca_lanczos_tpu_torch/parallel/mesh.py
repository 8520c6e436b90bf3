"""Meshes of ranks for row-sharded CA-Lanczos on ``torch.distributed``.

Counterpart of ``ca_lanczos_tpu/parallel/mesh.py``.  The JAX package's
mesh is a set of devices under one controller; here it is one process per
rank (SPMD): every rank runs the same program, owns one device
(``cuda:{local_rank}``, or the CPU when the caller asks for it) and holds
only its own row block.  NCCL carries the collectives between cards, gloo
between CPU ranks.

Two shapes, as in the JAX package:

* **flat** ``('rows',)`` over every rank of the default process group
  (:func:`make_mesh`);
* **hierarchical** ``('host', 'chip')`` (:func:`make_hier_mesh`): row
  blocks go host-major, ``p = host * C + chip``, so the halo ring crosses
  a host boundary only at the ``(h, C-1) <-> (h+1, 0)`` pairs; the
  reductions run over the chip group first and then the host group, and
  the TSQR tree has a chip level and a host level (``dist_orth``).

``row_sharding``, ``row_spec`` and ``replicated`` named XLA shardings;
here they return placers whose ``place(x)`` puts a host array on the rank
(its row block, or a replicated copy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

ROWS = "rows"
HOST = "host"
CHIP = "chip"

#: The row-axis handle: ``"rows"`` on a flat mesh, ``(HOST, CHIP)`` on a
#: hierarchical one (linearized host-major).
RowAxes = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a mesh: its shape and axis names, its linear
    rank ``p`` (host-major on a hierarchical mesh), its device, and on a
    hierarchical mesh the process groups of its host (``chip_group``) and
    of its chip index across hosts (``host_group``)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    chip_group: Optional[object] = None
    host_group: Optional[object] = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def hierarchical(self) -> bool:
        return len(self.shape) > 1

    @property
    def host(self) -> int:
        return self.rank // self.shape[-1]

    @property
    def chip(self) -> int:
        return self.rank % self.shape[-1]


def _world(n: int, what: str) -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{what}: no process group; start the ranks with "
            "parallel.runtime.spawn or initialize_multihost first"
        )
    world = dist.get_world_size()
    if world < n:
        # A smaller mesh than asked would run a "P-way" solve on fewer
        # shards and mislabel every scaling figure downstream.
        raise ValueError(
            f"{what}: only {world} rank(s) in the process group "
            f"({dist.get_backend()}); launch {n} ranks"
        )
    if world > n:
        raise ValueError(
            f"{what}: the process group has {world} ranks; a mesh spans "
            "all of them (launch as many ranks as the mesh has shards)"
        )
    return world


def _device(device) -> torch.device:
    from ca_lanczos_tpu_torch.parallel.runtime import rank_device

    return torch.device(device) if device is not None else rank_device()


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D ``('rows',)`` mesh over the default process group.  ``n_devices``
    defaults to the world size; any other count raises (no silent
    truncation).  ``device`` defaults to the rank's device."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    n = world if n_devices is None else int(n_devices)
    _world(n, f"make_mesh({n})")
    return Mesh(shape=(n,), axis_names=(ROWS,), rank=dist.get_rank(), device=_device(device))


def make_hier_mesh(n_hosts: Optional[int] = None, chips_per_host: Optional[int] = None,
                   device=None) -> Mesh:
    """2-D ``('host', 'chip')`` mesh of ``n_hosts`` x ``chips_per_host``
    ranks (``torch.distributed.device_mesh.init_device_mesh``); rank
    ``p`` is host ``p // C``, chip ``p % C``.  ``n_hosts`` defaults to 1
    and ``chips_per_host`` to the world size over ``n_hosts``."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 0
    H = 1 if n_hosts is None else int(n_hosts)
    C = (world // H if H else 0) if chips_per_host is None else int(chips_per_host)
    _world(H * C, f"make_hier_mesh({H}, {C})")
    dev = _device(device)
    dm = init_device_mesh(dev.type, (H, C), mesh_dim_names=(HOST, CHIP))
    return Mesh(shape=(H, C), axis_names=(HOST, CHIP), rank=dist.get_rank(), device=dev,
                chip_group=dm.get_group(CHIP), host_group=dm.get_group(HOST))


def row_axes(mesh: Mesh) -> RowAxes:
    """``"rows"`` on a flat mesh, ``("host", "chip")`` on a hierarchical one."""
    names = mesh.axis_names
    return names[0] if len(names) == 1 else tuple(names)


@dataclasses.dataclass(frozen=True)
class RowPlacer:
    """Places the rank's block of dimension ``dim`` of a host array (split
    in ``mesh.size`` equal blocks, zero-padded to a multiple of them), or,
    with ``block``, rows ``[rank*block, (rank+1)*block)`` zero-padded (a
    block-row operator's shards hold whole block rows)."""

    mesh: Mesh
    dim: int = 0
    block: Optional[int] = None

    def place(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        n = t.shape[self.dim]
        P = self.mesh.size
        nl = -(-n // P) if self.block is None else self.block
        lo = self.mesh.rank * nl
        blk = t.narrow(self.dim, min(lo, n), max(0, min(nl, n - lo)))
        if blk.shape[self.dim] < nl:
            pad = list(blk.shape)
            pad[self.dim] = nl - blk.shape[self.dim]
            blk = torch.cat([blk, blk.new_zeros(pad)], dim=self.dim)
        return blk.contiguous().to(self.mesh.device)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Places a full copy of a host array on the rank's device."""

    mesh: Mesh

    def place(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        return t.contiguous().to(self.mesh.device)


def row_spec(mesh: Mesh, *, lead_none: int = 0) -> RowPlacer:
    """Placer sharding dimension ``lead_none`` over all row axes (the
    ``(s, n)`` powers layout uses ``lead_none=1``)."""
    return RowPlacer(mesh, lead_none)


def row_sharding(mesh: Mesh) -> RowPlacer:
    """Placer for (n, ...) arrays split along rows."""
    return RowPlacer(mesh, 0)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)
