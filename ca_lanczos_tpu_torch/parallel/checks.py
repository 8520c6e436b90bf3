"""Per-rank computations that hold the distributed layer against its
references.

The test suite starts gloo ranks once per file (``runtime.spawn`` with
:func:`run`) and compares what each case returns with the JAX package on
the same numpy inputs; a spawned rank can only run functions of this
package, so the cases live here.  Every case takes the mesh first and
numpy inputs after, and returns host data (whole vectors gathered on
every rank), so rank 0's answer is the distributed answer.
"""

from __future__ import annotations

import traceback
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
from ca_lanczos_tpu_torch.parallel import comm
from ca_lanczos_tpu_torch.parallel.mesh import Mesh, make_hier_mesh, make_mesh, row_sharding


def run(specs: Sequence[Tuple[str, str, dict]], hier: Optional[Tuple[int, int]] = None) -> dict:
    """Run ``specs`` — (case id, function of this module, kwargs) — on this
    rank over the flat mesh of every rank, or the ``hier`` (H, C) mesh for
    a spec whose kwargs say ``hier=True``.  A case that raises records
    ``{"__error__": traceback}``.  Returns {case id: result}."""
    flat = make_mesh()
    hmesh = make_hier_mesh(*hier) if hier else None
    out = {}
    for cid, fname, kw in specs:
        kw = dict(kw)
        mesh = hmesh if kw.pop("hier", False) else flat
        comm.reset()
        try:
            out[cid] = globals()[fname](mesh, **kw)
        except Exception:  # recorded: the test of this case fails with it
            out[cid] = {"__error__": traceback.format_exc()}
    return out


def _dia(data, offsets) -> DiaMatrix:
    return DiaMatrix(data=torch.as_tensor(np.asarray(data)), offsets=tuple(offsets))


def _dist(mesh: Mesh, data, offsets, s_max: int, periodic: bool = False, ilv: bool = False):
    from ca_lanczos_tpu_torch.parallel.distributed import DistDia

    return DistDia.from_dia(_dia(data, offsets), mesh, s_max=s_max, periodic=periodic, ilv=ilv)


def spmv(mesh, data, offsets, x, s_max, periodic=False):
    from ca_lanczos_tpu_torch.parallel.distributed import dist_spmv

    A = _dist(mesh, data, offsets, s_max, periodic)
    return A.gather_columns(dist_spmv(A, A.shard_vector(x), mesh))


def powers(mesh, data, offsets, x, s, diag=None, sub=None, s_max=None, periodic=False,
           rows=False):
    """(n, s+1) powers, or with ``rows`` the (s, n) rows-native block."""
    from ca_lanczos_tpu_torch.parallel.distributed import (
        dist_matrix_powers,
        dist_matrix_powers_rows,
    )

    A = _dist(mesh, data, offsets, s_max or s, periodic)
    fn = dist_matrix_powers_rows if rows else dist_matrix_powers
    V = fn(A, A.shard_vector(x), s, diag, sub, mesh)
    return A.gather_columns(V.T).T if rows else A.gather_columns(V)


def qr(mesh, X, method="tsqr", safe=False, key=0, mp=False):
    """Distributed QR of the global X (rows split over the ranks): the
    gathered Q, the replicated R (and the rank with ``safe``)."""
    from ca_lanczos_tpu_torch.parallel.dist_orth import local_cholqr, local_qr, local_qr_safe

    Xl = row_sharding(mesh).place(X)
    if safe:
        Q, R, rank = local_qr_safe(Xl, method, key=key, mesh=mesh)
    elif method == "cholqr":
        Q, R = local_cholqr(Xl, mp, mesh)
    else:
        Q, R = local_qr(Xl, method, mp, mesh)
    calls = list(comm.CALLS)
    out = {"Q": torch.cat(comm.all_gather(Q.contiguous()))[: X.shape[0]], "R": R,
           "calls": calls}
    if safe:
        out["rank"] = rank
    return out


def psum(mesh, X):
    """Row ``mesh.rank`` of X summed over the ranks."""
    from ca_lanczos_tpu_torch.parallel.dist_orth import psum_rows

    return psum_rows(torch.as_tensor(X[mesh.rank]).to(mesh.device), mesh)


def ca_lanczos(mesh, data, offsets, r, s, steps, want_Q=False, **kw):
    from ca_lanczos_tpu_torch.parallel.driver import dist_ca_lanczos

    res = dist_ca_lanczos(_dia(data, offsets), r, s, steps, mesh, **kw)
    return {"T": res.T, "Q": res.Q if want_Q else None}


def restarted(mesh, data, offsets, r, max_lanczos, cfg, **kw):
    from ca_lanczos_tpu_torch.parallel.restarted import dist_restarted_ca_lanczos

    res = dist_restarted_ca_lanczos(_dia(data, offsets), r, max_lanczos, mesh, cfg, **kw)
    return {"eigs": res.eigs, "Q": res.Q_conv, "converged": res.converged,
            "n_restarts": res.n_restarts}


def irl(mesh, data, offsets, r, max_lanczos, **kw):
    from ca_lanczos_tpu_torch.parallel.dist_irl import dist_impl_restarted_ca_lanczos

    res = dist_impl_restarted_ca_lanczos(_dia(data, offsets), r, max_lanczos, mesh, **kw)
    return {"eigs": res.eigs, "Q": res.Q_conv, "converged": res.converged,
            "n_restarts": res.n_restarts}


def lanczos(mesh, data, offsets, r, maxiter):
    from ca_lanczos_tpu_torch.parallel.driver import dist_lanczos

    T, _ = dist_lanczos(_dia(data, offsets), r, maxiter, mesh)
    return T


def solve_auto(mesh, a, r, max_lanczos, cfg, **kw):
    from ca_lanczos_tpu_torch.parallel.auto import dist_solve_auto

    res = dist_solve_auto(a, r, max_lanczos, mesh, cfg, **kw)
    return {"eigs": res.eigs, "Q": res.Q_conv, "converged": res.converged,
            "solver": res.solver, "n_restarts": res.n_restarts,
            "polish_resid": res.polish_resid, "escalated": res.escalated,
            "perm": None if res.route is None else res.route.perm,
            "format": None if res.route is None else res.route.format}


def route(mesh, a, s_max, **kw):
    """The route's (format, operator type, perm is None, bandwidths), or
    the ValueError's message."""
    from ca_lanczos_tpu_torch.parallel.auto import route_dist_operator

    try:
        A, fmt, rt = route_dist_operator(a, mesh, s_max, **kw)
    except ValueError as e:
        return {"error": str(e)}
    return {"format": fmt, "type": type(A).__name__, "perm_none": rt.perm is None,
            "bw_before": rt.bandwidth_before, "bw_after": rt.bandwidth_after,
            "notes": rt.notes}


def partition_refuses(mesh, a=None, dist_format="auto"):
    """The error ``partition_operator`` raises for ``a`` (a scipy matrix
    made an EllMatrix; None: a plain object)."""
    from ca_lanczos_tpu_torch.ops.spmv import EllMatrix
    from ca_lanczos_tpu_torch.parallel.step import partition_operator

    op = object() if a is None else EllMatrix.from_scipy(a, device="cpu")
    try:
        partition_operator(op, mesh, s_max=4, dist_format=dist_format)
    except (TypeError, ValueError) as e:
        return {"type": type(e).__name__, "msg": str(e)}
    return {"type": None}


def make_mesh_refuses(mesh, n):
    try:
        make_mesh(n)
    except ValueError as e:
        return str(e)
    return None


def determinism(mesh, data, offsets, s):
    """Bitwise repeatability of the first block step and the spread of its
    replicated R across the ranks."""
    from ca_lanczos_tpu_torch.parallel.step import dist_first_block
    from ca_lanczos_tpu_torch.utils.debug import check_deterministic, cross_device_consistency

    A = _dist(mesh, data, offsets, s)
    q = A.shard_vector(np.ones(A.n))
    z = np.zeros(s)
    det = check_deterministic(lambda: dist_first_block(A, q, z, z, s, mesh), reps=3)
    _, R = dist_first_block(A, q, z, z, s, mesh)
    return {"deterministic": det, "spread": cross_device_consistency(R)}


def ilv_powers(mesh, data, offsets, x, s, diag, sub, periodic=False):
    """dist_matrix_powers_ilv decoded to natural (s, n)."""
    from ca_lanczos_tpu_torch.parallel.distributed import (
        dist_ilv_decode,
        dist_ilv_encode,
        dist_matrix_powers_ilv,
    )

    A = _dist(mesh, data, offsets, s, periodic, ilv=True)
    W = dist_matrix_powers_ilv(A, dist_ilv_encode(A, x, mesh), s, diag, sub, mesh)
    return dist_ilv_decode(A, W)


def ilv_chain(mesh, data, offsets, x, s, diag, sub, blocks, periodic=False):
    """``blocks`` chained ilv_padded_powers calls in the padded domain
    (``last`` feeds the next block), decoded."""
    from ca_lanczos_tpu_torch.parallel.distributed import (
        _coefs,
        dist_ilv_decode,
        dist_ilv_encode,
        ilv_pad_state,
        ilv_padded_powers,
        ilv_unpad_state,
    )

    A = _dist(mesh, data, offsets, s, periodic, ilv=True)
    cur = ilv_pad_state(A, dist_ilv_encode(A, x, mesh))
    for _ in range(blocks):
        _, cur = ilv_padded_powers(A, cur, _coefs(diag, sub, s), s, mesh)
    return dist_ilv_decode(A, ilv_unpad_state(A, cur))


def ilv_roundtrip(mesh, data, offsets, x):
    from ca_lanczos_tpu_torch.parallel.distributed import dist_ilv_decode, dist_ilv_encode

    A = _dist(mesh, data, offsets, 4, ilv=True)
    enc = dist_ilv_encode(A, x, mesh)
    st = A.shard_entry(x)
    return {"decoded": dist_ilv_decode(A, enc), "entry_exit": A.gather_columns(st),
            "m_pad": A.ilv_m_pad}


def comm_powers(mesh, data, offsets, s, s_max):
    """The collectives of one dist_matrix_powers call on this rank."""
    from ca_lanczos_tpu_torch.parallel.distributed import dist_matrix_powers

    A = _dist(mesh, data, offsets, s_max)
    x = A.shard_vector(np.ones(A.n, np.asarray(data).dtype))
    comm.reset()
    dist_matrix_powers(A, x, s, None, None, mesh)
    return dict(comm.snapshot(), halo=A.halo)


def comm_ilv_powers(mesh, data, offsets, s):
    """The collectives of one dist_matrix_powers_ilv call on this rank."""
    from ca_lanczos_tpu_torch.parallel.distributed import dist_ilv_encode, dist_matrix_powers_ilv

    A = _dist(mesh, data, offsets, s, ilv=True)
    x = dist_ilv_encode(A, np.ones(A.n, np.asarray(data).dtype), mesh)
    comm.reset()
    dist_matrix_powers_ilv(A, x, s, None, None, mesh)
    return comm.snapshot()


def comm_ca(mesh, data, offsets, r, s, steps, **kw):
    """The collectives of a whole dist_ca_lanczos run on this rank."""
    from ca_lanczos_tpu_torch.parallel.driver import dist_ca_lanczos

    comm.reset()
    dist_ca_lanczos(_dia(data, offsets), r, s, steps, mesh, **kw)
    return comm.snapshot()


def comm_block(mesh, data, offsets, s):
    """The collectives of one dist_ca_block call on this rank."""
    from ca_lanczos_tpu_torch.parallel.step import dist_ca_block

    A = _dist(mesh, data, offsets, s)
    n = A.n
    Q = A.shard_vector(np.ones((n, s + 1), np.asarray(data).dtype) / np.sqrt(n))
    comm.reset()
    dist_ca_block(A, Q, None, None, s, mesh)
    return dict(comm.snapshot(), n_local=A.n_local)


def interop(mesh, jdata, offsets, halo, n, periodic, s_max, ilv):
    """This rank's planes three ways: the JAX shard ``jdata[p]`` through
    ``utils.interop.dist_dia_from_numpy``, and ``DistDia.from_dia`` of the
    gathered rows; each with its interleaved planes when ``ilv``."""
    from types import SimpleNamespace

    from ca_lanczos_tpu_torch.utils.interop import dist_dia_from_numpy

    P, nd, m = jdata.shape
    rows = np.concatenate([jdata[q, :, halo:m - halo] for q in range(P)], axis=1)[:, :n]
    J = dist_dia_from_numpy(SimpleNamespace(data=jdata, offsets=offsets, halo=halo, n=n,
                                            periodic=periodic), mesh, ilv=ilv)
    A = _dist(mesh, rows, offsets, s_max, periodic, ilv=ilv)
    return {"interop": J.data, "from_dia": A.data, "halo": A.halo,
            "interop_ilv": J.ilv_data, "from_dia_ilv": A.ilv_data}
