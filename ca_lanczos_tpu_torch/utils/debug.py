"""Numerical-debug utilities — the single-process stand-in for race
detection / sanitizers (SURVEY.md section 5): deterministic-output checks
and NaN guards.

Counterpart of ``ca_lanczos_tpu/utils/debug.py``.  A structure is walked
as JAX walks a pytree: tuples, lists, dict values and dataclass fields
are descended into, ``None`` holds nothing, anything else (a tensor, an
array, a number) is a leaf.  ``cross_device_consistency`` all-gathers a
nominally replicated tensor over the ranks of the process group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch


def _leaves(tree) -> Iterator:
    if tree is None:
        return
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        yield tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def assert_finite(tree, where: str = "") -> None:
    """Host-side NaN/Inf guard over a nested structure of tensors/arrays."""
    for leaf in _leaves(tree):
        arr = _host(leaf)
        if not np.all(np.isfinite(arr)):
            bad = int(np.sum(~np.isfinite(arr)))
            raise FloatingPointError(f"{bad} non-finite values {('in ' + where) if where else ''}")


def check_deterministic(fn: Callable, *args, reps: int = 2) -> bool:
    """Run fn ``reps`` times and require bitwise-identical outputs (the
    same structure, and every leaf equal), so that restart trajectories
    are reproducible."""
    ref = [_host(x) for x in _leaves(fn(*args))]
    for _ in range(reps - 1):
        out = [_host(x) for x in _leaves(fn(*args))]
        if len(out) != len(ref) or not all(np.array_equal(a, b) for a, b in zip(ref, out)):
            return False
    return True


def cross_device_consistency(x, atol: float = 0.0) -> float:
    """Max deviation of a nominally replicated tensor or array across the
    ranks of the default process group (an all-gather; every rank must
    call it): 0.0 means every rank holds identical bytes.  0.0 without a
    process group or at one rank."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() < 2:
        return 0.0
    from ca_lanczos_tpu_torch.parallel import comm
    from ca_lanczos_tpu_torch.parallel.runtime import rank_device

    t = torch.as_tensor(_host(x)).to(rank_device())
    shards = [s.cpu().numpy() for s in comm.all_gather(t)]
    ref = shards[0]
    dev = max(float(np.max(np.abs(s - ref))) if s.size else 0.0 for s in shards[1:])
    if atol and dev > atol:
        raise AssertionError(f"cross-device deviation {dev} > {atol}")
    return dev
