"""Final f64-operator Rayleigh–Ritz polish of a converged block.

Counterpart of ``ca_lanczos_tpu/solvers/polish.py``.  A loose f32 solve
inherits the f32 rounding of its SpMVs and the f32 REPRESENTATION error
of the matrix (~eps_f32 * ||A||, a ~6e-8 relative floor no f32-side
iteration crosses).  This pass runs after the solve against the f64
operator planes: block-Krylov Rayleigh–Ritz, residual expansion of depth
``depth`` per pass.

PRECISION SPLIT (kept from the TPU package, docstring :19-34): the panel
GEMMs — CGS projections, CholQR2, fast-pass RR assembly — run in f32;
float64 appears where it buys accuracy:

* the SpMV against the TRUE f64 planes;
* residual formation AQ - Q w in f64 before the DIRECTION is cast to f32;
* the final per-vector Rayleigh quotients and residuals (f64 elementwise
  dots), and the final pass's generalized Gram pair G = Z^T A Z,
  M = Z^T Z, solved on the host (scipy ``eigh(G, M)``).

Dropped TPU-only workarounds: the row-major (k, n) panels (TPU lanes pad
the minor dimension; the card does not) and the byte-budgeted f64 chunks
(a (11M, 65) f64 panel is 5.7 GB, which fits 80 GB).  Panels here are
(n, k) like the host variant.

This module owns every decision of the polish that ``solve_auto`` and
``dist_solve_auto`` run: which f64 operator it runs against
(``f64_operator``, counted in ``POLISH_PREP``), when it stops
(``_SETTLE``, ``_SETTLE_PASSES``) and which pairs it returns
(``polish_block``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from ca_lanczos_tpu_torch.ops.formats import dia_from_scipy
from ca_lanczos_tpu_torch.ops.qr import cholqr2
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
from ca_lanczos_tpu_torch.utils.spans import span

DEPTH = 4  # the passes' default residual expansion depth
_POLISH_MAX_DIAGS = 48  # most diagonals the device polish takes
# A vector stored in f32 carries up to u = 2^-24 of rounding in each entry,
# so its f64 residual cannot fall much below u ||A|| (||A|| bounded by the
# largest absolute row sum).  Polished pairs settle at 0.1-1.1 u ||A|| on
# the impurity and Ising chains (32,768-65,536 rows, CPU); a slow polish
# reads 29 u ||A|| after six passes (tests/test_torch_auto.py's smallest
# end).  A block that came from the solve without a level it needed reads
# 370-480 u ||A|| after ten (the Ising chain at 65,536 rows on the CPU and
# at 4,194,304 on the card): above _SETTLE u ||A|| the polish goes on.
_SETTLE = 32.0
_SETTLE_PASSES = 8  # most further passes, each at twice the depth
# one per f64_operator call, by the branch that built its f64 operator
POLISH_PREP = {"device_upcast": 0, "raw_dia": 0, "host_csr": 0}


def _unit_cols(B: torch.Tensor) -> torch.Tensor:
    return B / torch.clamp_min(torch.linalg.norm(B, dim=0), 1e-300)[None, :]


def _rq64(A64, Q: torch.Tensor):
    """Per-vector f64 Rayleigh quotients, residual norms, and the f32
    residual DIRECTION block."""
    Q64 = Q.double()
    AQ = A64.matvec(Q64)
    w = torch.sum(Q64 * AQ, dim=0) / torch.sum(Q64 * Q64, dim=0)
    R = AQ - w[None, :] * Q64
    return w, torch.linalg.norm(R, dim=0), _unit_cols(R.float())


def _polish_pass(A64, A32, X: torch.Tensor, k: int, depth: int, final: bool):
    """One block-Krylov RR pass on the f32 (n, k) block X; returns
    (w (k,) f64 Rayleigh quotients, resid (k,) f64, Q (n, k) f32)."""
    with span("polish.orth"):
        Q = cholqr2(X.float())[0]
    _, _, B = _rq64(A64, Q)

    stages = [Q]
    for d in range(depth):
        with span("polish.orth"):
            for _ in range(2):  # CGS2 against previous stages (f32)
                for Sx in stages:
                    B = B - Sx @ (Sx.T @ B)
            B = cholqr2(_unit_cols(B))[0]
        stages.append(B)
        if d < depth - 1:
            # Krylov expansion stages ride the f32 twin: only the FIRST
            # residual direction is cancellation-sensitive (f64 in _rq64).
            B = _unit_cols(A32.matvec(B))

    Z = torch.cat(stages, dim=1)  # (n, m k)
    with span("polish.rr"):
        if final:
            # f64 generalized Gram pair: the f32 Gram's ~sqrt(n)*eps_f32 error
            # would re-inject subspace mixing at every rotation.
            Z64 = Z.double()
            if depth <= DEPTH:
                AZ = A64.matvec(Z64)
            else:  # k columns at a time: no more memory than a pass at DEPTH
                AZ = torch.empty_like(Z64)
                for j in range(0, AZ.shape[1], k):
                    AZ[:, j:j + k] = A64.matvec(Z64[:, j:j + k])
            G = (Z64.T @ AZ).cpu().numpy()
            del AZ
            M = (Z64.T @ Z64).cpu().numpy()
            wa, Ua = sla.eigh((G + G.T) / 2, (M + M.T) / 2)
        else:
            G = (Z.T @ A32.matvec(Z)).double().cpu().numpy()
            wa, Ua = np.linalg.eigh((G + G.T) / 2)
    order = np.argsort(wa)[::-1][:k]
    Uk = torch.as_tensor(np.ascontiguousarray(Ua[:, order]), dtype=torch.float32,
                         device=Z.device)
    ZU = Z @ Uk
    with span("polish.orth"):
        Q = cholqr2(ZU)[0]
    w, resid, _ = _rq64(A64, Q)
    return w.cpu().numpy(), resid.cpu().numpy(), Q


def rayleigh_ritz_polish(A64, X, iters: int = 3, depth: int = DEPTH
                         ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Polish a locked block against the f64 operator on its device.

    A64: a DiaMatrix with FLOAT64 planes that hold the matrix's values
    exactly: the solve's own planes upcast on the device when they hold
    the raw matrix bit for bit (an f32 raw matrix in f32 planes), else
    planes built from the raw matrix in f64 (``f64_operator``)
    — never an f32 rounding of an f64 matrix.
    X: (n, k) converged block, any float dtype, natural row order.
    Returns (eigs desc (k,) f64, true absolute residuals ||Ax - wx|| (k,)
    f64, polished orthonormal block (n, k) f32 on A64's device)."""
    if A64.dtype != torch.float64:
        raise ValueError(f"polish needs f64 operator planes, got {A64.dtype}")
    k = int(X.shape[1])
    # f32 twin for the non-cancellation-sensitive applies
    A32 = DiaMatrix(data=A64.data.float(), offsets=A64.offsets)
    Q = torch.as_tensor(X, device=A64.device).float()
    w = resid = None
    total = max(int(iters), 1)
    for it in range(total):
        with span("polish.pass", it):
            w, resid, Q = _polish_pass(A64, A32, Q, k, int(depth), final=(it == total - 1))
    return w, resid, Q


def rayleigh_ritz_polish_host(matvec, X, iters: int = 3, depth: int = 4
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host f64 polish, for operators the device polish does not take
    (general sparsity, permuted routes).  Same algorithm as the TPU
    package's host variant; the panel algebra runs on CPU tensors (with it
    in numpy, the 4,194,304-row flagship polish took 318.26 s on the host
    of an NVIDIA H100 80GB HBM3 at 700 W; with CPU tensors, 99.85 s).

    matvec: callable (n, j) f64 numpy -> (n, j) f64 numpy applying the
    TRUE f64 operator (e.g. a scipy.sparse matrix's __matmul__).
    X: (n, k) block (numpy or a tensor, any float dtype).
    Returns (w desc (k,) f64, true residuals (k,), Q (n, k) f64 numpy)."""
    X = torch.as_tensor(np.asarray(X.detach().cpu() if isinstance(X, torch.Tensor) else X),
                        dtype=torch.float64)
    k = X.shape[1]

    def apply(Z):
        return torch.from_numpy(np.asarray(matvec(Z.contiguous().numpy()), np.float64))

    def orth(Z):
        # CholQR2: orthonormal to roundoff in f64 for the conditioning here.
        for _ in range(2):
            G = Z.T @ Z
            L = torch.linalg.cholesky(
                G + torch.trace(G) * 1e-15 * torch.eye(len(G), dtype=G.dtype))
            Z = torch.linalg.solve_triangular(L.T, Z, upper=True, left=False)
        return Z.contiguous()

    def unit(Z):
        return Z / torch.clamp_min(torch.linalg.norm(Z, dim=0), 1e-300)[None, :]

    Q = orth(X)
    AQ = apply(Q)
    w = torch.sum(Q * AQ, dim=0)

    for it in range(max(int(iters), 1)):
        with span("polish.pass", it):
            stages = [Q]
            B = unit(AQ - Q * w[None, :])
            for d in range(depth):
                for _ in range(2):
                    for Sx in stages:
                        B = torch.addmm(B, Sx, Sx.T @ B, alpha=-1.0)  # B - Sx (Sx^T B)
                B = orth(unit(B))
                stages.append(B)
                if d < depth - 1:
                    B = unit(apply(B))
            Z = torch.cat(stages, dim=1)  # (n, mk), orthonormal-ish
            AZ = apply(Z)
            G = (Z.T @ AZ).numpy()
            M = (Z.T @ Z).numpy()
            wa, Ua = sla.eigh((G + G.T) / 2, (M + M.T) / 2)
            order = np.argsort(wa)[::-1][:k]
            Q = orth(Z @ torch.from_numpy(np.ascontiguousarray(Ua[:, order])))
            AQ = apply(Q)
            w = torch.sum(Q * AQ, dim=0)
    resid = torch.linalg.norm(AQ - Q * w[None, :], dim=0)
    return w.numpy(), resid.numpy(), Q.numpy()


def f64_operator(raw, A_solve, route, which, device="cuda"):
    """The polish against the f64 operator of the first branch that
    applies, built once (counted in ``POLISH_PREP``; the ``polish.prep``
    span's args name it), as ``(run(Q, iters, depth), ||A||'s bound)``,
    the bound the largest absolute row sum; ``run`` returns (w desc in the
    solve frame, resid, Q (n, k) tensor), w/resid aligned with Q's columns:

    * ``device_upcast``: the solve operator's own DIA planes (already
      negated for ``which="smallest"``) upcast on their device, when
      they hold the raw matrix's values exactly (``_planes_hold_raw``),
      or when there is no raw matrix (representation-limited if the
      planes were stored f32);
    * ``raw_dia``: f64 DIA planes of an unpermuted raw (host) matrix
      with at most ``_POLISH_MAX_DIAGS`` diagonals, built on the device
      from its CSR arrays (``ops.formats.dia_from_scipy``);
    * ``host_csr``: the native CSR SpMM in f64 on the host
      (``ops._spmm_native``): general sparsity, permuted routes.

    The device is the solve operator's, or ``device`` when there is none
    (the distributed solve polishes the gathered block against the raw
    matrix alone)."""
    A64 = None
    if isinstance(A_solve, DiaMatrix) and (raw is None or _planes_hold_raw(raw, A_solve, route)):
        POLISH_PREP["device_upcast"] += 1
        with span("polish.prep", "device_upcast"):
            A64 = DiaMatrix(data=A_solve.data.double(), offsets=A_solve.offsets)
    elif raw is not None and (route is None or route.perm is None):
        dev = A_solve.device if A_solve is not None else torch.device(device)
        with span("polish.prep", "raw_dia"):
            csr = sp.csr_matrix(raw)
            if not csr.has_canonical_format:  # sum duplicates in f64, in a copy
                csr = csr.astype(np.float64)
            # None above the limit: scattered sparsity would materialize O(n^2) planes
            A64 = dia_from_scipy(csr, max_diags=_POLISH_MAX_DIAGS, waste_cap=np.inf,
                                 dtype=np.float64, device=dev)
            if A64 is not None and which == "smallest":
                A64.data.neg_()
        if A64 is not None:
            POLISH_PREP["raw_dia"] += 1
    if A64 is not None:
        def run(Q, iters, depth):
            return rayleigh_ritz_polish(A64, Q, iters=iters, depth=depth)

        return run, float(A64.data.abs().sum(dim=0).max())
    from ca_lanczos_tpu_torch.ops._spmm_native import CsrMatmul

    POLISH_PREP["host_csr"] += 1
    with span("polish.prep", "host_csr"):
        csr = sp.csr_matrix(raw).astype(np.float64)
        mm = CsrMatmul(csr)
        norm = float(np.max(abs(csr).sum(axis=1)))
    matvec = (lambda Z: -mm(Z)) if which == "smallest" else mm

    def run(Q, iters, depth):
        w, resid, Qp = rayleigh_ritz_polish_host(matvec, Q, iters=iters, depth=depth)
        return w, resid, torch.from_numpy(Qp)

    return run, norm


def _planes_hold_raw(raw, A, route) -> bool:
    """True when the route's DIA planes ``A``, upcast to f64, are bit for
    bit the f64 planes of ``raw``: an unpermuted route, a raw dtype the
    planes hold exactly, no duplicate entries left in ``raw`` that the
    route summed in the planes' dtype (the f64 build sums them in f64),
    and at most ``_POLISH_MAX_DIAGS`` diagonals."""
    planes = {torch.float32: np.float32, torch.float64: np.float64}.get(A.data.dtype)
    dtype = raw.dtype if sp.issparse(raw) else np.asarray(raw).dtype
    return (route is not None and route.perm is None and planes is not None
            and np.can_cast(dtype, planes, "safe")
            and getattr(raw, "nnz", route.nnz) == route.nnz
            and len(A.offsets) <= _POLISH_MAX_DIAGS)


def _settled(resid, keep: int, norm: float) -> bool:
    """True when each of the first ``keep`` pairs' residual lies within
    ``_SETTLE`` u ``norm`` (the f32 level, see ``_SETTLE``)."""
    return bool(np.all(np.asarray(resid)[:keep] <= _SETTLE * 2.0**-24 * norm))


def polish_block(raw, A_solve, route, Q, which, iters: int, depth: int, keep: int,
                 device="cuda"):
    """f64 Rayleigh-Ritz polish of a converged block ``Q`` in the caller's
    frame: ``iters`` passes against ``f64_operator``'s operator, then at
    most ``_SETTLE_PASSES`` further passes at twice ``depth`` while one of
    the first ``keep`` pairs has not settled (``_settled``): at ``depth``
    the Ising chain's unsettled blocks took three times the passes and
    stopped three times higher (CPU, 8,192 and 65,536 rows).  Returns the
    first ``keep`` pairs, (w desc in the solve frame, resid, Q), then the
    passes run and whether those pairs settled."""
    run, norm = f64_operator(raw, A_solve, route, which, device)
    w, resid, Qp = run(Q, iters, depth)
    extra = 0
    while extra < _SETTLE_PASSES and not _settled(resid, keep, norm):
        with span("polish.settle", extra):
            w, resid, Qp = run(Qp, 1, 2 * depth)
        extra += 1
    settled = _settled(resid, keep, norm)
    keep = min(keep, len(w))
    return w[:keep], resid[:keep], Qp[:, :keep], max(int(iters), 1) + extra, settled
