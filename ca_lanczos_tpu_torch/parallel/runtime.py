"""Process-group runtime, the rank launcher and the scaling sweep.

Counterpart of ``ca_lanczos_tpu/parallel/runtime.py``:

* :func:`initialize_multihost` — ``torch.distributed.init_process_group``
  for a rank started by ``torchrun`` (rank, world size and address from
  the environment) or by hand (explicit arguments); NCCL with
  ``device_id`` on the card, gloo on the CPU, always with a timeout, so a
  collective that one rank skips fails instead of hanging.
* :func:`spawn` — start ``world`` ranks on this host (``torch.
  multiprocessing``, start method "spawn"; a file store in a temporary
  directory), run ``fn(*args)`` on each, and return every rank's result;
  every rank is killed at the deadline.  ``fn`` must be a module-level
  function of this package (a child unpickles it by module name).
* :func:`scaling_sweep` — weak scaling of ``dist_matrix_powers_rows``
  over mesh widths: nnz/s a device and the efficiency against the
  smallest mesh, one :func:`spawn` per width.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as _queue
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_RANK_DEVICE: Optional[torch.device] = None


def rank_device() -> torch.device:
    """The device this rank owns (set by :func:`initialize_multihost`);
    ``cuda:{LOCAL_RANK}`` when no launcher set one."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
    local_rank: Optional[int] = None,
    timeout: float = 600.0,
) -> int:
    """Join the default process group; returns the world size.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``
    or ``file://path``); without it the ``torchrun`` environment
    (MASTER_ADDR/MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) is read.
    ``device="cuda"`` binds the rank to ``cuda:{local_rank}`` and uses
    NCCL; ``"cpu"`` uses gloo."""
    global _RANK_DEVICE
    if coordinator_address is None:
        coordinator_address = "env://"
    rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    lr = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else int(local_rank)
    kw = dict(init_method=coordinator_address, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout))
    if device == "cuda":
        if torch.cuda.device_count() <= lr:
            raise RuntimeError(f"rank {rank}: cuda:{lr} does not exist "
                               f"({torch.cuda.device_count()} visible)")
        _RANK_DEVICE = torch.device("cuda", lr)
        torch.cuda.set_device(_RANK_DEVICE)
        dist.init_process_group("nccl", device_id=_RANK_DEVICE, **kw)
    elif device == "cpu":
        _RANK_DEVICE = torch.device("cpu")
        dist.init_process_group("gloo", **kw)
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dist.get_world_size()


def _host(x):
    """Results cross the process boundary as host data."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _child(rank, world, device, init_method, timeout, threads, fn, args, q):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize_multihost(init_method, world, rank, device=device, local_rank=rank,
                             timeout=timeout)
        out = fn(*args)
        q.put((rank, True, pickle.dumps(_host(out))))
    except Exception:  # the rank's failure, reported to the parent
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, device: str, *args, timeout: float = 900.0,
          threads: Optional[int] = None) -> List:
    """Run ``fn(*args)`` on ``world`` ranks of this host and return their
    results in rank order.

    ``device="cuda"`` gives rank r the card ``cuda:r`` and NCCL, and
    refuses when fewer cards are visible than ranks; ``"cpu"`` gives gloo
    ranks on the CPU.  ``threads`` sets each rank's torch thread count.
    A rank that raises fails the call with its traceback; at ``timeout``
    seconds every rank still running is killed and TimeoutError raised.
    Results must pickle; tensors come back as numpy arrays."""
    if device == "cuda":
        visible = torch.cuda.device_count()
        if visible < world:
            raise ValueError(f"spawn({world} ranks): only {visible} CUDA device(s) visible")
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="cal_store_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, world, device, init, timeout, threads, fn, args, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        results: Dict[int, object] = {}
        failure = None
        try:
            while len(results) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn: {world - len(results)} of {world} ranks still running "
                        f"after {timeout:.0f} s; killed")
                try:
                    rank, ok, payload = q.get(timeout=min(left, 1.0))
                except _queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and q.empty():
                        time.sleep(0.5)
                        if q.empty():
                            failure = f"a rank exited with code {dead[0]} and no result"
                    continue
                if ok:
                    results[rank] = pickle.loads(payload)
                else:
                    failure = f"rank {rank} failed:\n{payload}"
        finally:
            for p in procs:
                if p.is_alive() and (failure is not None or len(results) < world):
                    p.kill()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failure is not None:
            raise RuntimeError(f"spawn: {failure}")
    return [results[r] for r in range(world)]


def _scaling_rank(rows_per_device: int, s: int, reps: int, dtype: str,
                  n_hosts: Optional[int]) -> Dict:
    """One rank of :func:`scaling_sweep` at one mesh width."""
    from ca_lanczos_tpu_torch.parallel.distributed import DistDia, dist_matrix_powers_rows
    from ca_lanczos_tpu_torch.parallel.mesh import make_hier_mesh, make_mesh
    from ca_lanczos_tpu_torch.utils.matrices import laplacian_1d

    P = dist.get_world_size()
    n = rows_per_device * P
    mesh = (make_hier_mesh(n_hosts, P // n_hosts)
            if n_hosts and P % n_hosts == 0 and P > n_hosts else make_mesh(P))
    tdt = torch.float64 if dtype == "float64" else torch.float32
    A = laplacian_1d(n, dtype=tdt, device="cpu")
    Adist = DistDia.from_dia(A, mesh, s_max=s)
    x = Adist.shard_vector(np.ones(n))
    z = np.zeros(s)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier()

    W = dist_matrix_powers_rows(Adist, x, s, z, z, mesh)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        W = dist_matrix_powers_rows(Adist, W[s - 1], s, z, z, mesh)
    sync()
    dt = torch.tensor([(time.perf_counter() - t0) / reps], dtype=torch.float64,
                      device=mesh.device)
    dist.all_reduce(dt, op=dist.ReduceOp.MAX)  # a block ends when its slowest rank does
    return {"rows": n, "nnz": A.nnz, "seconds_per_block": float(dt.item())}


def scaling_sweep(
    device_counts: Sequence[int],
    rows_per_device: int = 1 << 18,
    s: int = 8,
    reps: int = 5,
    dtype=torch.float32,
    n_hosts: Optional[int] = None,
    device: str = "cuda",
) -> List[Dict]:
    """Weak-scaling sweep: at each count P, P ranks (:func:`spawn`) chain
    ``reps`` s-step blocks of ``dist_matrix_powers_rows`` on the 1-D
    Laplacian of ``rows_per_device * P`` rows.  ``n_hosts`` builds
    hierarchical meshes.  One record per count: nnz/s, nnz/s a device and
    the weak efficiency against the first count."""
    records = []
    base = None
    dt_name = str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) else np.dtype(dtype).name
    for P in device_counts:
        out = spawn(_scaling_rank, int(P), device, rows_per_device, s, reps, dt_name, n_hosts)[0]
        rate = out["nnz"] * s / out["seconds_per_block"]
        per_dev = rate / P
        if base is None:
            base = per_dev
        records.append({
            "devices": int(P),
            "rows": out["rows"],
            "nnz_per_s": rate,
            "nnz_per_s_per_device": per_dev,
            "weak_efficiency": per_dev / base,
            "seconds_per_block": out["seconds_per_block"],
        })
    return records
