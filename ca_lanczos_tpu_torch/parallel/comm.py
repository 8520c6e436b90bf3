"""The collectives of the distributed layer, counted.

Every exchange, all-reduce, all-gather and broadcast of ``parallel/``
goes through here, so that the communication model (one halo exchange per
s-step block, ``2*s*w`` elements a rank; O(block^2) reductions,
independent of n) is checked by counting, not by reading code.
``COUNTS`` are this process's totals since :func:`reset`; ``PEERS`` the
(source, destination) global ranks of every halo send; ``CALLS`` the
(kind, global ranks of the group, elements) of every all-reduce and
all-gather.
"""

from __future__ import annotations

import pickle
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

COUNTS = {"exchanges": 0, "halo_elems": 0, "all_reduce": 0, "all_reduce_elems": 0,
          "all_gather": 0, "all_gather_elems": 0, "broadcast": 0}
PEERS: List[Tuple[int, int]] = []
CALLS: List[Tuple[str, Tuple[int, ...], int]] = []


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    PEERS.clear()
    CALLS.clear()


def snapshot() -> dict:
    return dict(COUNTS, peers=list(PEERS), calls=list(CALLS))


def _ranks(group) -> Tuple[int, ...]:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """One halo exchange: post every send ``(tensor, dst)`` and receive
    ``(buffer, src)`` together (``batch_isend_irecv``) and wait.  The i-th
    send to a peer matches that peer's i-th receive from this rank (tags
    count them, so two messages to one neighbour on a ring of two stay
    apart).  Tensors must be contiguous."""
    COUNTS["exchanges"] += 1
    me = dist.get_rank()
    ops = []
    tag_out: dict = {}
    for t, dst in sends:
        tag = tag_out.get(dst, 0)
        tag_out[dst] = tag + 1
        ops.append(dist.P2POp(dist.isend, t, dst, tag=tag))
        COUNTS["halo_elems"] += t.numel()
        PEERS.append((me, dst))
    tag_in: dict = {}
    for t, src in recvs:
        tag = tag_in.get(src, 0)
        tag_in[src] = tag + 1
        ops.append(dist.P2POp(dist.irecv, t, src, tag=tag))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over ``group`` (None: every rank), in place; returns ``t``."""
    COUNTS["all_reduce"] += 1
    COUNTS["all_reduce_elems"] += t.numel()
    CALLS.append(("all_reduce", _ranks(group), t.numel()))
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape everywhere), in group rank order."""
    COUNTS["all_gather"] += 1
    COUNTS["all_gather_elems"] += t.numel()
    CALLS.append(("all_gather", _ranks(group), t.numel()))
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def broadcast_object(obj, device: torch.device, src: int = 0):
    """``obj`` of rank ``src`` on every rank (pickled into a byte tensor on
    ``device``: NCCL moves device tensors only).  Other ranks pass None."""
    COUNTS["broadcast"] += 1
    if dist.get_rank() == src:
        buf = np.frombuffer(pickle.dumps(obj), np.uint8)
        size = torch.tensor([buf.size], dtype=torch.int64, device=device)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=device)
    dist.broadcast(size, src)
    if dist.get_rank() == src:
        data = torch.from_numpy(buf.copy()).to(device)
    else:
        data = torch.empty(int(size.item()), dtype=torch.uint8, device=device)
    dist.broadcast(data, src)
    if dist.get_rank() == src:
        return obj
    return pickle.loads(data.cpu().numpy().tobytes())


def on_root(fn, device: torch.device, src: int = 0):
    """``fn()`` computed on rank ``src`` alone and broadcast, so that every
    rank takes its decisions from the same bytes.  An exception on ``src``
    is raised on every rank (the others would wait forever otherwise)."""
    out = None
    if dist.get_rank() == src:
        try:
            out = (True, fn())
        except Exception as e:  # re-raised below, on every rank
            out = (False, f"{type(e).__name__}: {e}")
    ok, val = broadcast_object(out, device, src)
    if not ok:
        raise RuntimeError(f"rank {src}: {val}")
    return val
