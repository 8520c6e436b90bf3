"""Per-rank computations that hold the distributed layer against its
references.

The test suite starts gloo ranks once per file (``runtime.spawn`` with
:func:`run`) and compares what each case returns with the JAX package on
the same numpy inputs; a spawned rank can only run functions of this
package, so the cases live here.  Every case takes the mesh first and
numpy inputs after, and returns host data (whole vectors gathered on
every rank), so rank 0's answer is the distributed answer.  A host
operator is given as planes, ``data``/``offsets`` (DIA) or ``op``: a
tuple ("dia", data, offsets), ("ell", vals, cols) or ("bsr", vals, cols).
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


def _host_op(data=None, offsets=None, op=None):
    """The host operator (CPU planes) of a case: DIA ``data``/``offsets``,
    or the ``op`` tuple (module docstring)."""
    from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
    from ca_lanczos_tpu_torch.ops.spmv import EllMatrix

    if op is None:
        return _dia(data, offsets)
    kind, a, b = op
    if kind == "dia":
        return _dia(a, b)
    cls = {"ell": EllMatrix, "bsr": BsrMatrix}[kind]
    return cls(vals=torch.as_tensor(np.asarray(a)), cols=torch.as_tensor(np.asarray(b),
                                                                         dtype=torch.int64))


def _dist_op(mesh, op, s_max: int, dist_format: str = "auto", periodic: bool = False,
             jax_part=None):
    """This rank's distributed operator: ``op`` partitioned by the port
    (``step.partition_operator``, or ``from_dia`` / ``from_ell`` with
    ``periodic``), or, with ``jax_part`` (a dict of a JAX distributed
    operator's stacked planes and statics), JAX's own partition carried
    across (``utils.interop.dist_operator_from_numpy``)."""
    from types import SimpleNamespace

    from ca_lanczos_tpu_torch.parallel.dist_ell import DistEll
    from ca_lanczos_tpu_torch.parallel.dist_pell import DistPell
    from ca_lanczos_tpu_torch.parallel.distributed import DistDia
    from ca_lanczos_tpu_torch.parallel.step import partition_operator
    from ca_lanczos_tpu_torch.utils.interop import dist_operator_from_numpy

    if jax_part is not None:
        return dist_operator_from_numpy(SimpleNamespace(**jax_part), mesh)
    A = _host_op(op=op)
    if not periodic:
        return partition_operator(A, mesh, s_max=s_max, dist_format=dist_format)
    if isinstance(A, DiaMatrix):
        return DistDia.from_dia(A, mesh, s_max=s_max, periodic=True)
    cls = DistPell if dist_format == "pell" else DistEll
    return cls.from_ell(A, mesh, s_max=s_max, periodic=True)


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


def ca_lanczos(mesh, data=None, offsets=None, *, r, s, steps, want_Q=False, op=None, **kw):
    from ca_lanczos_tpu_torch.parallel.driver import dist_ca_lanczos

    res = dist_ca_lanczos(_host_op(data, offsets, op), r, s, steps, mesh, **kw)
    return {"T": res.T, "Q": res.Q if want_Q else None, "op": type(res.op).__name__}


def restarted(mesh, data=None, offsets=None, *, r, max_lanczos, cfg, op=None, **kw):
    from ca_lanczos_tpu_torch.parallel.restarted import dist_restarted_ca_lanczos

    res = dist_restarted_ca_lanczos(_host_op(data, offsets, op), r, max_lanczos, mesh, cfg,
                                    **kw)
    return {"eigs": res.eigs, "Q": res.Q_conv, "converged": res.converged,
            "n_restarts": res.n_restarts}


def irl(mesh, data=None, offsets=None, *, r, max_lanczos, op=None, **kw):
    from ca_lanczos_tpu_torch.parallel.dist_irl import dist_impl_restarted_ca_lanczos

    res = dist_impl_restarted_ca_lanczos(_host_op(data, offsets, op), r, max_lanczos, mesh,
                                         **kw)
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


def partition(mesh, a=None, dist_format="auto", kind="ell"):
    """What ``partition_operator`` makes of ``a`` (a scipy matrix made an
    EllMatrix, or with ``kind="bsr"`` a 4x4-tile BsrMatrix; None: a plain
    object) at s_max=4: the distributed operator's type, halo and rows and
    whether partitioning it again passes it through, or the error's type
    and message."""
    from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
    from ca_lanczos_tpu_torch.ops.spmv import EllMatrix
    from ca_lanczos_tpu_torch.parallel.step import partition_operator

    if a is None:
        op = object()
    elif kind == "bsr":
        op = BsrMatrix.from_scipy(a, block_size=4, device="cpu")
    else:
        op = EllMatrix.from_scipy(a, device="cpu")
    try:
        D = partition_operator(op, mesh, s_max=4, dist_format=dist_format)
    except (TypeError, ValueError) as e:
        return {"type": type(e).__name__, "msg": str(e)}
    return {"type": None, "op": type(D).__name__, "halo": D.halo, "n_local": D.n_local,
            "same": partition_operator(D, mesh, s_max=4, dist_format=dist_format) is D}


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


# ---------------------------------------------------------------------------
# The second slice: ELL, PELL, BSR, s-step, propagation
# ---------------------------------------------------------------------------


def gen_powers(mesh, op, x, s, diag=None, sub=None, s_max=None, dist_format="auto",
               periodic=False, jax_part=None, state=None):
    """(n, s+1) powers of a distributed ELL / PELL / BSR / DIA operator
    (``dist_matrix_powers`` of its type), gathered; ``state`` names the
    driver state's dtype when it differs from the operator's (the f64
    state on f32 planes); also the operator's type and halo."""
    from ca_lanczos_tpu_torch.parallel import (
        DistBsr,
        DistEll,
        DistPell,
        dist_bsr_matrix_powers,
        dist_ell_matrix_powers,
        dist_matrix_powers,
        dist_pell_matrix_powers,
    )

    A = _dist_op(mesh, op, s_max or s, dist_format, periodic, jax_part)
    fn = {DistEll: dist_ell_matrix_powers, DistPell: dist_pell_matrix_powers,
          DistBsr: dist_bsr_matrix_powers}.get(type(A), dist_matrix_powers)
    x_l = A.shard_vector(x).to(getattr(torch, state) if state else A.dtype)
    V = fn(A, x_l, s, diag, sub, mesh)
    return {"V": A.gather_columns(V), "type": type(A).__name__, "halo": A.halo,
            "dtype": str(V.dtype).split(".")[-1], "planes": str(A.dtype).split(".")[-1]}


def gen_spmv(mesh, op, x, s_max=4, dist_format="auto"):
    """One ``_dist_spmv_any`` product (column 1 of the s = 1 powers for a
    DistEll / DistPell / DistBsr), gathered."""
    from ca_lanczos_tpu_torch.parallel.restarted import _dist_spmv_any

    A = _dist_op(mesh, op, s_max, dist_format)
    return A.gather_columns(_dist_spmv_any(A, A.shard_entry(x), mesh))


def comm_gen_powers(mesh, op, s, dist_format="auto"):
    """The collectives of one s-step powers call on a distributed ELL /
    PELL / BSR operator on this rank (and its halo)."""
    from ca_lanczos_tpu_torch.parallel.step import _powers

    A = _dist_op(mesh, op, s, dist_format)
    x = A.shard_entry(np.ones(A.n))
    comm.reset()
    _powers(A, x, np.zeros((s, 2)), s, mesh)
    return dict(comm.snapshot(), halo=A.halo)


def sstep(mesh, data, offsets, r, s, m):
    """``dist_sstep_lanczos``: the replicated T and the gathered Q."""
    from ca_lanczos_tpu_torch.parallel.dist_sstep import dist_sstep_lanczos

    res = dist_sstep_lanczos(_dia(data, offsets), r, s, m, mesh)
    n = np.asarray(r).shape[0]
    return {"T": res.T, "Q": torch.cat(comm.all_gather(res.Q.contiguous()))[:n]}


def spmv_cols(mesh, op, x, s_max=1, periodic=False):
    """``dist_spmv_cols`` of a global (n, c) multivector, gathered."""
    from ca_lanczos_tpu_torch.parallel.dist_prop import dist_spmv_cols

    A = _dist_op(mesh, op, s_max, periodic=periodic)
    return A.gather_columns(dist_spmv_cols(A, A.shard_vector(x), mesh))


def propagate(mesh, op, psi0, dt, n_steps, krylov_dim=24, periodic=True, **kw):
    """``dist_propagate_split`` of a DistDia / DistEll (periodic by
    default): the final complex psi on the host."""
    from ca_lanczos_tpu_torch.parallel.dist_prop import dist_propagate_split

    A = _dist_op(mesh, op, 1, periodic=periodic)
    return dist_propagate_split(A, psi0, dt, n_steps, mesh, krylov_dim=krylov_dim, **kw)
