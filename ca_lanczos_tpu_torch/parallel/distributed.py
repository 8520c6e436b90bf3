"""Row-sharded DIA operator and the halo-exchange matrix powers.

Counterpart of ``ca_lanczos_tpu/parallel/distributed.py``.  The matrix is
split in contiguous row blocks, one per rank, and the s-step block
``[x, p_1(A)x, ..., p_s(A)x]`` costs ONE boundary exchange per s products:

* each rank holds its rows PLUS the s-deep ghost rows of the matrix
  (cut at partition time: ``DistDia.data`` is ``(nd, n_local + 2*halo)``);
* one exchange per block (``batch_isend_irecv`` pairs with the ring
  neighbours, ``comm.exchange``) brings the ``halo = s_max*w`` vector
  rows on each side; edge ranks get zeros unless the operator is
  periodic, and a periodic ring of one rank wraps locally;
* the s local steps then run on the padded domain through the kernel K1
  (``ops.cuda_spmv.dia_powers_fused``; K2 steps where ``k1_plan_for``
  says "steps"; the plain recurrence for CPU tensors).  K1's zero
  boundary outside ``[0, m)`` plays the role of the JAX package's zero
  padding: step k pollutes only the outer k*w rows, so the centre
  ``[halo, halo + n_local)`` stays exact.

Volume per block: ``2*s*w`` elements a rank, one round instead of s.

**The interleaved engine** (``ilv=True``): each rank also holds the
interleaved planes (``ops.cuda_ilv`` layout, J = 8) of its padded domain
``[start - HJ, start + n_local + HJ)`` with ``HJ = J * ILV_HALO_Q = 1024``
ghost rows a side.  Per interleave plane that domain is ``[ghost (128 q)
| centre (nq) | ghost (128 q)]``, so driver state can stay interleaved
across blocks: only the (J, 128) edge blocks are exchanged, and K3
(``ops.cuda_ilv.dia_powers_ilv``) runs on ``(nd, ilv_m_pad)``.  The TPU's
tile-major flat planes and its 65536/1024-aligned ``dflat`` layout were
Mosaic artifacts and are gone; ``ilv_m_pad`` is the padded domain itself.

SPMD: every function runs on every rank with that rank's blocks; vectors
are the rank's rows (``(state_len,)`` or ``(state_len, k)`` tensors).
:meth:`DistDia.gather_columns` and :func:`dist_ilv_decode` all-gather
and return the whole vector on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.cuda_ilv import J, WQ, ilv_decode, ilv_encode, ilv_plan, max_carry
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
from ca_lanczos_tpu_torch.parallel import comm
from ca_lanczos_tpu_torch.parallel.mesh import Mesh, RowPlacer

# Ghost depth of the interleaved engine in q-units a plane: 1024 natural
# rows a side.
ILV_HALO_Q = 128
HJ = J * ILV_HALO_Q


def _ilv_plan(offsets: Sequence[int], nd: int, n_local: int, s_max: int, dtype) -> Tuple[int, str]:
    """(ilv_m_pad, reason): the padded interleaved domain of one shard, or
    0 and why the shard cannot run the interleaved engine (the route note
    ``dist_solve_auto`` shows)."""
    name = str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) else np.dtype(dtype).name
    if name != "float32":
        return 0, f"dtype {name} != float32 (the ilv engine takes f32 planes)"
    w = max((abs(o) for o in offsets), default=0)
    if s_max * w > HJ:
        return 0, f"s_max*bandwidth {s_max * w} exceeds the {HJ}-row exchanged edge"
    carry = max_carry(offsets)
    if s_max * carry > WQ:
        return 0, f"s_max*carry {s_max * carry} exceeds the kernel q-halo {WQ}"
    if HJ > n_local or n_local % HJ:
        return 0, f"shard size {n_local} not a multiple of {HJ} rows"
    m = n_local + 2 * HJ
    if ilv_plan(nd, carry, 1, torch.float32) is None:
        return 0, f"no K3 window fits the padded shard ({m} rows, {nd} diagonals)"
    return m, ""


def _ilv_planes(data: torch.Tensor, offsets: Sequence[int], n_local: int, s_max: int,
                p: int, periodic: bool, device) -> Tuple[Optional[torch.Tensor], int]:
    """(interleaved planes of rank p's padded domain on ``device``,
    ilv_m_pad) from the whole operator's natural planes ``data (nd, n)``,
    or (None, 0) when the shard does not admit the interleaved engine."""
    from ca_lanczos_tpu_torch.ops.cuda_ilv import _encode_planes

    m_pad, _ = _ilv_plan(offsets, data.shape[0], n_local, s_max, data.dtype)
    if not m_pad:
        return None, 0
    return _encode_planes(_window(data, p * n_local - HJ, m_pad, periodic)).to(device), m_pad


def check_s_bound(A, s: int) -> None:
    """A deeper matrix-powers call than the partition-time halo supports
    would pollute the owned centre rows: refuse it."""
    smax = getattr(A, "s_max", 0)
    if smax and s > smax:
        raise ValueError(
            f"s={s} exceeds the operator's partition-time s_max={smax}: "
            "halos were sized at partition time — rebuild the operator "
            "with a larger s_max"
        )


def dist_ilv_admissible(A: DiaMatrix, n_devices: int, s_max: int) -> Tuple[bool, str]:
    """(ok, reason) from shapes and dtype alone: can this DiaMatrix run the
    interleaved engine on ``n_devices`` ranks?"""
    nd, n = A.data.shape
    m, reason = _ilv_plan(A.offsets, nd, -(-n // n_devices), s_max, A.data.dtype)
    return bool(m), reason


def _window(data: torch.Tensor, lo: int, length: int, periodic: bool) -> torch.Tensor:
    """Columns [lo, lo + length) of ``data (nd, n)``: zero outside [0, n),
    or wrapped mod n when periodic."""
    nd, n = data.shape
    out = data.new_zeros((nd, length))
    hi = lo + length
    a, b = max(lo, 0), min(hi, n)
    if b > a:
        out[:, a - lo:b - lo] = data[:, a:b]
    if periodic:
        if lo < 0:
            out[:, : -lo] = data[:, n + lo:]
        if hi > n:
            out[:, n - lo:] = data[:, : hi - n]
    return out


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


class RowState:
    """The driver-state contract shared by the distributed operators
    (DistDia, DistEll, DistPell, DistBsr; the JAX package's
    ``RowStateMixin``).

    A driver keeps its n-sized state (Krylov blocks, locked basis,
    histories) in the operator's state domain, ``(state_len[, k])`` rows
    a rank, and enters and leaves it only at the ends of a solve: the
    rank's natural rows here, the padded interleaved domain when a
    DistDia runs the interleaved engine (it overrides :meth:`to_state`,
    :meth:`local_natural` and ``state_len``).  State is ghost-zero in
    either domain, so the all-reduced Grams, CGS and TSQR are the same
    code on every operator.  A subclass gives ``n``, ``mesh``, ``dtype``,
    ``device`` and ``n_local``; the rank's rows are global rows
    ``[rank*n_local, (rank+1)*n_local)``."""

    ilv_engine = False

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def state_len(self) -> int:
        """Rows of this rank's driver state vectors."""
        return self.n_local

    def _cast(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The operator's planes ``t`` in ``dtype``: ``t`` itself, or a
        copy made on the first call and kept (``self._casts``)."""
        if dtype == t.dtype:
            return t
        if dtype not in self._casts:
            self._casts[dtype] = t.to(dtype)
        return self._casts[dtype]

    def shard_vector(self, x) -> torch.Tensor:
        """This rank's rows of a global (n,) or (n, k) host vector,
        zero-padded, on the rank's device (dtype kept)."""
        return RowPlacer(self.mesh, block=self.n_local).place(x)

    def to_state(self, rows: torch.Tensor) -> torch.Tensor:
        """The rank's natural rows (n_local[, k]) -> driver state."""
        return rows

    def local_natural(self, Q: torch.Tensor) -> torch.Tensor:
        """This rank's state (state_len[, k]) -> its natural rows (n_local[, k])."""
        return Q

    def shard_entry(self, x) -> torch.Tensor:
        """Entry into the driver state domain, in the operator's dtype
        (a driver that wants wider state, the IRL, upcasts after entry)."""
        return self.to_state(self.shard_vector(_tensor(x).to(self.dtype)))

    def state_zeros(self, cols: int, dtype=None) -> torch.Tensor:
        """Zero state, (state_len, cols) (a transposed view of (cols,
        state_len) rows, so each column is contiguous), or (state_len,)
        with cols=0."""
        dtype = self.dtype if dtype is None else dtype
        if not cols:
            return torch.zeros(self.state_len, dtype=dtype, device=self.device)
        return torch.zeros((cols, self.state_len), dtype=dtype, device=self.device).T

    def gather_columns(self, Q) -> np.ndarray:
        """Exit from the state domain: every rank's rows gathered into the
        global (n, k) or (n,) host array (natural order, trimmed), on
        every rank.  Collective."""
        Qn = self.local_natural(Q)
        parts = comm.all_gather(Qn.contiguous())
        return torch.cat(parts, dim=0)[: self.n].cpu().numpy()


@dataclasses.dataclass(frozen=True, eq=False)
class DistDia(RowState):
    """This rank's block of a row-sharded DIA operator.

    data: (nd, n_local + 2*halo) — global rows [p*n_local - halo,
        (p+1)*n_local + halo), zero outside [0, n) (or wrapped when
        periodic).
    halo: ghost depth in rows, >= s_max * max|offset|.
    ilv_data: (nd, ilv_m_pad) interleaved planes of the padded domain
        (``ilv=True``); the operator then runs the interleaved engine and
        driver state lives in that domain (``state_len = ilv_m_pad``).
    """

    data: torch.Tensor
    offsets: Tuple[int, ...]
    halo: int
    n: int
    mesh: Mesh
    periodic: bool = False
    ilv_data: Optional[torch.Tensor] = None
    ilv_m_pad: int = 0
    _casts: dict = dataclasses.field(default_factory=dict, repr=False)

    def planes(self, dtype: torch.dtype) -> torch.Tensor:
        """``data`` in ``dtype``: the planes themselves, or a copy made on
        the first call and kept (wider driver state, the IRL's f64 on f32
        planes, multiplies in its own precision, as the JAX package's
        promotion does)."""
        return self._cast(self.data, dtype)

    @property
    def n_local(self) -> int:
        return self.data.shape[1] - 2 * self.halo

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def bandwidth(self) -> int:
        return max(abs(k) for k in self.offsets) if self.offsets else 0

    @property
    def s_max(self) -> int:
        """Largest s the stored halo supports."""
        w = self.bandwidth
        return self.halo // w if w else 10**9

    @property
    def ilv_engine(self) -> bool:
        """True when the drivers run this operator on the interleaved engine."""
        return self.ilv_data is not None

    @property
    def state_len(self) -> int:
        return self.ilv_m_pad if self.ilv_engine else self.n_local

    @staticmethod
    def from_dia(A: DiaMatrix, mesh: Mesh, s_max: int, periodic: bool = False,
                 ilv: bool = False) -> "DistDia":
        """This rank's block of ``A`` (planes on any device) with an
        s_max-deep halo, on ``mesh.device``.  Rows are zero-padded to a
        multiple of the shard count.  ``periodic=True`` reads the planes
        as circulant-banded (``A[i, (i+off) mod n] = data[d, i]``) and
        fills the ghost rows from the wrapped end; n must then divide
        evenly.  ``ilv=True`` also builds the interleaved planes when the
        shard admits them (:func:`dist_ilv_admissible`), else skips them."""
        P, p = mesh.size, mesh.rank
        data = A.data
        n = data.shape[1]
        w = max(abs(k) for k in A.offsets) if A.offsets else 0
        n_local = -(-n // P)
        halo = max(1, s_max * w)
        if halo >= n_local:
            raise ValueError(
                f"halo {halo} >= shard size {n_local}: increase rows/device or lower s")
        if periodic and n_local * P != n:
            raise ValueError(f"periodic operator: n={n} must divide evenly over {P} shards")
        block = _window(data, p * n_local - halo, n_local + 2 * halo, periodic)
        ilv_data, m_pad = (_ilv_planes(data, A.offsets, n_local, s_max, p, periodic, mesh.device)
                           if ilv else (None, 0))
        return DistDia(data=block.contiguous().to(mesh.device), offsets=tuple(A.offsets),
                       halo=halo, n=n, mesh=mesh, periodic=periodic,
                       ilv_data=ilv_data, ilv_m_pad=m_pad)

    # -- the interleaved engine's state domain ------------------------------

    def ilv_shard_vector(self, x) -> torch.Tensor:
        """Entry into the padded interleaved domain: this rank's
        (ilv_m_pad[, k]) state with zero ghosts."""
        if self.ilv_data is None:
            raise ValueError("operator built without ilv=True")
        return ilv_pad_state(self, ilv_encode(self.shard_vector(x)))

    def to_state(self, rows: torch.Tensor) -> torch.Tensor:
        return ilv_pad_state(self, ilv_encode(rows)) if self.ilv_engine else rows

    def local_natural(self, Q: torch.Tensor) -> torch.Tensor:
        if not self.ilv_engine:
            return Q
        return ilv_decode(ilv_unpad_state(self, Q))


# ---------------------------------------------------------------------------
# Natural engine
# ---------------------------------------------------------------------------


def _ring(P: int, p: int, periodic: bool) -> Tuple[Optional[int], Optional[int]]:
    """(left, right) neighbours of rank p on the linear ring, None at an
    open edge.  On a hierarchical mesh the linear order is host-major, so
    only the host-boundary pairs leave a host."""
    if periodic:
        return (p - 1) % P, (p + 1) % P
    return (p - 1 if p > 0 else None), (p + 1 if p < P - 1 else None)


def _edge_exchange(first: torch.Tensor, last: torch.Tensor, mesh: Mesh,
                   periodic: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``last`` to the right neighbour and ``first`` to the left one;
    returns (from_left, from_right): the left neighbour's ``last`` and the
    right neighbour's ``first`` (zeros at an open edge).  A periodic ring
    of one rank wraps locally (a send to oneself is refused)."""
    P, p = mesh.size, mesh.rank
    if P == 1:
        comm.COUNTS["exchanges"] += 1
        if periodic:
            return last.clone(), first.clone()
        return torch.zeros_like(last), torch.zeros_like(first)
    left, right = _ring(P, p, periodic)
    from_left, from_right = torch.zeros_like(last), torch.zeros_like(first)
    sends, recvs = [], []
    if right is not None:
        sends.append((last.contiguous(), right))
    if left is not None:
        sends.append((first.contiguous(), left))
    if left is not None:
        recvs.append((from_left, left))
    if right is not None:
        recvs.append((from_right, right))
    comm.exchange(sends, recvs)
    return from_left, from_right


def _halo_exchange(x_local: torch.Tensor, halo: int, mesh: Mesh,
                   periodic: bool = False) -> torch.Tensor:
    """The padded vector [left halo | x_local | right halo] (one exchange)."""
    fl, fr = _edge_exchange(x_local[:halo], x_local[-halo:], mesh, periodic)
    return torch.cat([fl, x_local, fr])


def _coefs(diag, sub, s: int) -> np.ndarray:
    c = np.zeros((s, 2))
    if diag is not None:
        c[:, 0] = np.asarray(torch.as_tensor(diag).cpu(), np.float64)[:s]
    if sub is not None:
        c[:, 1] = np.asarray(torch.as_tensor(sub).cpu(), np.float64)[:s]
    return c


def _k1_rows(data: torch.Tensor, x: torch.Tensor, coefs: np.ndarray,
             offsets: Tuple[int, ...], s: int) -> torch.Tensor:
    """s recurrence steps from x on planes ``data`` with zero boundary:
    K1, or s K2 launches where K1's plan says "steps" (the plain
    recurrence for CPU tensors).  Returns V (s, m)."""
    from ca_lanczos_tpu_torch.ops import cuda_spmv

    if x.device.type == "cuda" and cuda_spmv.k1_plan_for(offsets, s, x.dtype).variant == "steps":
        V = x.new_empty((s, x.shape[0]))
        prev, cur = None, x
        for j in range(s):
            V[j] = cuda_spmv.dia_power_step(data, cur, prev, coefs[j], offsets)
            prev, cur = cur, V[j]
        return V
    V, _ = cuda_spmv.dia_powers_fused(data, x, coefs, offsets, s)
    return V


def _powers_local(A: DistDia, x_local: torch.Tensor, coefs: np.ndarray, s: int,
                  mesh: Mesh, include_q: bool = True) -> torch.Tensor:
    """One halo exchange + s local steps of V[k+1] = A V[k] - c[k,0] V[k]
    - c[k,1] V[k-1] on the padded vector.  Returns rows: (s+1, n_local)
    with x first, or (s, n_local) with ``include_q=False``."""
    x_local = x_local.contiguous()
    xp = _halo_exchange(x_local, A.halo, mesh, A.periodic)
    V = _k1_rows(A.planes(xp.dtype), xp, coefs, A.offsets, s)
    center = V[:, A.halo:A.halo + x_local.shape[0]]
    if not include_q:
        return center
    return torch.cat([x_local[None, :], center], dim=0)


def dist_matrix_powers(A: DistDia, x: torch.Tensor, s: int, diag, sub,
                       mesh: Mesh) -> torch.Tensor:
    """This rank's (n_local, s+1) block of [x, p_1(A)x, ..., p_s(A)x] for
    the three-term recurrence with ``diag``/``sub`` coefficients (zeros:
    the monomial basis).  A transposed view of contiguous rows."""
    check_s_bound(A, s)
    return _powers_local(A, x, _coefs(diag, sub, s), s, mesh).T


def dist_matrix_powers_rows(A: DistDia, x: torch.Tensor, s: int, diag, sub,
                            mesh: Mesh) -> torch.Tensor:
    """Rows-native powers: this rank's (s, n_local) recurrence vectors
    without the leading x (a chained consumer reads ``W[s-1]``)."""
    check_s_bound(A, s)
    return _powers_local(A, x, _coefs(diag, sub, s), s, mesh, include_q=False)


def dist_spmv(A: DistDia, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One distributed product A x (1-deep use of the stored halo): the
    local product on the padded vector is K2 on CUDA (``spmv``), in x's
    precision."""
    from ca_lanczos_tpu_torch.ops.spmv import spmv

    x = x.contiguous()
    xp = _halo_exchange(x, A.halo, mesh, A.periodic)
    y = spmv(DiaMatrix(data=A.planes(xp.dtype), offsets=A.offsets), xp)
    return y[A.halo:A.halo + x.shape[0]]


# ---------------------------------------------------------------------------
# Interleaved engine (padded domain, per-plane ghosts)
# ---------------------------------------------------------------------------


def _planes(A: DistDia, xp: torch.Tensor) -> torch.Tensor:
    """View of padded-domain state (m_pad[, k]) or rows (r, m_pad) as
    (..., J, nqp[, k]) interleave planes."""
    nqp = A.ilv_m_pad // J
    if xp.shape[0] == A.ilv_m_pad:
        return xp.reshape((J, nqp) + tuple(xp.shape[1:]))
    return xp.reshape(tuple(xp.shape[:-1]) + (J, nqp))


def ilv_statics(A: DistDia, s: int) -> dict:
    """The interleaved engine's shapes for ``s`` steps (for callers that
    size their own buffers)."""
    return dict(offsets=A.offsets, n_shards=A.n_shards, s=s, n_local=A.n_local,
                ilv_m_pad=A.ilv_m_pad, periodic=A.periodic)


def ilv_refresh_ghosts(A: DistDia, xp: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Padded-domain state (ilv_m_pad,) with its ghost q-slices filled from
    the ring neighbours' centres (zeros at an open edge): the two (J, 128)
    edge blocks are all that is exchanged.  Returns a new tensor."""
    nq = A.n_local // J
    xp = xp.clone(memory_format=torch.contiguous_format)
    pl = _planes(A, xp)
    first = pl[:, ILV_HALO_Q:2 * ILV_HALO_Q].contiguous()
    last = pl[:, nq:nq + ILV_HALO_Q].contiguous()
    fl, fr = _edge_exchange(first, last, mesh, A.periodic)
    pl[:, :ILV_HALO_Q] = fl
    pl[:, ILV_HALO_Q + nq:2 * ILV_HALO_Q + nq] = fr
    return xp


def ilv_zero_ghosts(A: DistDia, xp: torch.Tensor) -> torch.Tensor:
    """Zero the ghost slices of padded-domain state (ilv_m_pad[, k]) or
    rows (r, ilv_m_pad), in place, so reductions see each global row once."""
    nq = A.n_local // J
    nqp = A.ilv_m_pad // J
    dim = 0 if xp.shape[0] == A.ilv_m_pad else xp.ndim - 1
    for r in range(J):
        xp.narrow(dim, r * nqp, ILV_HALO_Q).zero_()
        xp.narrow(dim, r * nqp + ILV_HALO_Q + nq, nqp - ILV_HALO_Q - nq).zero_()
    return xp


def ilv_padded_powers(A: DistDia, xp: torch.Tensor, coefs, s: int,
                      mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ghost refresh + K3 on the rank's padded interleaved domain.  Returns
    (V2 (s, ilv_m_pad), last): ``last`` chains into the next call; V2 rows
    feed reductions after :func:`ilv_zero_ghosts`."""
    from ca_lanczos_tpu_torch.ops.cuda_ilv import dia_powers_ilv

    if A.ilv_data is None:
        raise ValueError("operator built without ilv=True")
    xk = ilv_refresh_ghosts(A, xp.to(A.ilv_data.dtype), mesh)
    c = coefs if coefs is None or isinstance(coefs, np.ndarray) else np.asarray(coefs)
    return dia_powers_ilv(A.ilv_data, xk, c, A.offsets, s)


def ilv_pad_state(A: DistDia, x_il):
    """Local interleaved segment (n_local[, k]) -> padded-domain state
    (ilv_m_pad[, k]) with zero ghosts.  Tensor or numpy in, same out."""
    nq = A.n_local // J
    nqp = A.ilv_m_pad // J
    is_t = isinstance(x_il, torch.Tensor)
    X = x_il if is_t else torch.as_tensor(np.asarray(x_il))
    rest = tuple(X.shape[1:])
    out = X.new_zeros((J, nqp) + rest)
    out[:, ILV_HALO_Q:ILV_HALO_Q + nq] = X.reshape((J, nq) + rest)
    out = out.reshape((A.ilv_m_pad,) + rest)
    return out if is_t else out.numpy()


def ilv_unpad_state(A: DistDia, xp):
    """Inverse of :func:`ilv_pad_state` for state (ilv_m_pad[, k]) or rows
    (r, ilv_m_pad) (then (r, n_local))."""
    nq = A.n_local // J
    is_t = isinstance(xp, torch.Tensor)
    X = xp if is_t else torch.as_tensor(np.asarray(xp))
    pl = _planes(A, X)
    if X.shape[0] == A.ilv_m_pad:
        out = pl[:, ILV_HALO_Q:ILV_HALO_Q + nq].reshape((A.n_local,) + tuple(X.shape[1:]))
    else:
        out = pl[..., ILV_HALO_Q:ILV_HALO_Q + nq].reshape(tuple(X.shape[:-1]) + (A.n_local,))
    return out if is_t else out.numpy()


def dist_ilv_encode(A: DistDia, x, mesh: Mesh) -> torch.Tensor:
    """This rank's segment of a global (n,) vector, zero-padded and
    interleaved (n_local,)."""
    return ilv_encode(A.shard_vector(x)).contiguous()


def dist_ilv_decode(A: DistDia, w_il) -> np.ndarray:
    """Every rank's interleaved segment (n_local,) or rows (k, n_local)
    gathered and decoded to natural order, trimmed to n (numpy, on every
    rank).  Collective."""
    W = torch.as_tensor(w_il)
    one = W.ndim == 1
    nat = ilv_decode(W if one else W.T)  # (n_local[, k])
    out = torch.cat(comm.all_gather(nat.contiguous()), dim=0)[: A.n].cpu().numpy()
    return out if one else out.T


def dist_matrix_powers_ilv(A: DistDia, x_il: torch.Tensor, s: int, diag, sub,
                           mesh: Mesh) -> torch.Tensor:
    """Powers in the per-rank interleaved layout: this rank's segment
    x_il (n_local,) -> W_il (s, n_local), row j interleaved like x_il."""
    if A.ilv_data is None:
        raise ValueError(
            "operator has no interleaved layout: build it with "
            "DistDia.from_dia(..., ilv=True) (f32, n_local % 1024 == 0, s_max bounds)")
    check_s_bound(A, s)
    V2, _ = ilv_padded_powers(A, ilv_pad_state(A, x_il), _coefs(diag, sub, s), s, mesh)
    return ilv_unpad_state(A, V2)


def dist_spmv_ilv(A: DistDia, xp: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One product in the padded interleaved domain: ghost-zero state
    (ilv_m_pad,) of any float dtype -> A xp there, ghosts re-zeroed, in
    xp's dtype."""
    if A.ilv_data is None:
        raise ValueError("operator built without ilv=True")
    V2, _ = ilv_padded_powers(A, xp, None, 1, mesh)
    return ilv_zero_ghosts(A, V2[0]).to(xp.dtype)
