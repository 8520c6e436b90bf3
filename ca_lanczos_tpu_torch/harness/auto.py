"""Escalation-routed eigensolve: the production "just solve it" entry.

Counterpart of ``ca_lanczos_tpu/harness/auto.py``.  ``solve_auto`` routes a
raw matrix to an operator on the chosen device, probes the spectrum to
order the drivers, walks the escalation ladder until a driver converges,
and optionally polishes the converged block in f64 (the two-stage
pipeline: ``polish=``, ``over_lock=``).

Raw input is routed onto ``device="cuda"`` unless the caller asks for
another device.

No cheap spectral probe reliably predicts which spectra defeat the
explicit-restart driver at a given budget, so ``solve_auto`` guarantees
by escalation: it runs the driver the probe prefers first and, if that
returns unconverged, walks the rest of the ladder at the same budget —
the other driver (explicit thick restart <-> implicitly-restarted with
locking), then the rescue rungs (full reorthogonalization at the case's
s; s=4 full-orth for both drivers; an m=96 IRL rung).  Every leg runs in
the port: ``engine="host"`` (the default) takes the host-controlled
``solvers.restarted.restarted_ca_lanczos`` for the explicit rung,
``engine="fused"`` the device-resident ``solvers.fused_restarted``; the
IRL rungs are ``solvers.implicitly_restarted.impl_restarted_ca_lanczos``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.config import LanczosConfig, Orth
from ca_lanczos_tpu_torch.harness.matrix_info import recommend_solver
from ca_lanczos_tpu_torch.utils.spans import span, stage


@dataclasses.dataclass
class AutoResult:
    eigs: np.ndarray
    Q_conv: Optional[torch.Tensor]
    converged: bool
    n_restarts: int
    solver: str  # driver that produced the result
    escalated: bool  # True when the first-choice driver failed
    route: Optional[object] = None  # OperatorRoute when A was raw input
    # true absolute residuals ||A x - w x|| after the f64 polish
    # (None when polish=0); aligned with eigs
    polish_resid: Optional[np.ndarray] = None
    # f64 polish passes run: ``polish``, and more when a pair had not settled
    polish_passes: int = 0
    # host wall seconds per stage: route, probe, solve, polish (each ends
    # with the device synchronised)
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def _n_locked(res) -> int:
    """Number of finite (genuinely locked) eigenvalues in a driver result."""
    e = np.atleast_1d(np.asarray(res.eigs, np.float64))
    return int(np.sum(np.isfinite(e)))


_M_LARGE = 96  # larger-basis rescue rung (see _ladder)
_CALLS = itertools.count(1)  # numbers each solve_auto span of the process
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
# one per _polish_block call, by the branch that built its f64 operator
POLISH_PREP = {"device_upcast": 0, "host_dia": 0, "host_csr": 0}


def _ladder(cfg: LanczosConfig, first: str, second: str,
            max_lanczos: Optional[int] = None):
    """Escalation ladder (same rungs as the TPU package): the two
    probe-ordered drivers at the case's config, then full-orth, s=4
    full-orth and m=96 rescue legs.  Returns [(driver, cfg, label,
    m_override), ...]."""
    attempts = [(first, cfg, first, None), (second, cfg, second, None)]
    if cfg.orth != Orth.FULL:
        c = dataclasses.replace(cfg, orth=Orth.FULL)
        attempts.append(
            ("impl_restarted_ca_lanczos", c, "impl_restarted_ca_lanczos[orth=full]", None))
    if cfg.s > 4:
        c4 = dataclasses.replace(cfg, s=4, orth=Orth.FULL)
        attempts.append(
            ("impl_restarted_ca_lanczos", c4, "impl_restarted_ca_lanczos[s=4,orth=full]",
             None))
        attempts.append(
            ("restarted_ca_lanczos", c4, "restarted_ca_lanczos[s=4,orth=full]", None))
    if max_lanczos is not None and max_lanczos < _M_LARGE:
        cf = dataclasses.replace(cfg, orth=Orth.FULL)
        attempts.append(
            ("impl_restarted_ca_lanczos", cf,
             f"impl_restarted_ca_lanczos[orth=full,m={_M_LARGE}]", _M_LARGE))
    return attempts


def _escalate(run, attempts):
    """Walk the ladder until a driver converges; otherwise keep the attempt
    that locked the most (finite) pairs.  Returns (result, label, escalated)."""
    best = best_label = None
    best_i = 0
    for i, (name, c, label, m) in enumerate(attempts):
        with span("solve.rung", label):
            res = run(name, c, m)
        if res.converged:
            return res, label, i > 0
        if best is None or _n_locked(res) > _n_locked(best):
            best, best_label, best_i = res, label, i
    return best, best_label, best_i > 0


def _run(solver: str, A, r, max_lanczos: int, cfg: LanczosConfig,
         engine: str = "host", cycles_per_call=None):
    if solver == "restarted_ca_lanczos":
        if engine == "fused":
            from ca_lanczos_tpu_torch.solvers.fused_restarted import (
                fused_restarted_ca_lanczos,
            )

            return fused_restarted_ca_lanczos(
                A, r, max_lanczos,
                n_wanted=cfg.n_wanted, s=cfg.s, basis=cfg.basis,
                tol=cfg.tol, max_restarts=cfg.max_restarts,
                mixed_precision=cfg.orth_params.mixed_precision,
                cycles_per_call=cycles_per_call,
            )
        from ca_lanczos_tpu_torch.solvers.restarted import restarted_ca_lanczos

        return restarted_ca_lanczos(A, r, max_lanczos, cfg)
    from ca_lanczos_tpu_torch.solvers.implicitly_restarted import (
        impl_restarted_ca_lanczos,
    )

    return impl_restarted_ca_lanczos(
        A, r, max_lanczos,
        n_wanted=cfg.n_wanted, s=cfg.s, basis=cfg.basis, orth=cfg.orth,
        tol=cfg.tol, max_restarts=cfg.max_restarts,
    )


def solve_auto(
    A,
    r,
    max_lanczos: int,
    cfg: Optional[LanczosConfig] = None,
    probe_steps: int = 40,
    engine: str = "host",
    which: str = "largest",
    cycles_per_call: Optional[int] = None,
    polish: int = 0,
    over_lock: int = 0,
    polish_depth: int = 4,
    device="cuda",
    **route_kwargs,
) -> AutoResult:
    """Solve for ``cfg.n_wanted`` extreme eigenpairs, escalating between
    drivers until one converges (module docstring).

    ``A`` may be a port operator (it keeps its device), or any square
    scipy.sparse / dense matrix, routed by ``ops.formats.make_operator``
    onto ``device`` (``route_kwargs`` forwarded: ``prefer``, the PELL
    encoder's ``tile`` / ``encoding`` / ``max_windows`` / ``sw``, ...);
    when the route reorders, ``r`` is encoded and ``Q_conv`` decoded here.
    A PELL operator reaches K4/K5 in every stage: normest, the probe and
    the Newton bootstrap through the ``spmv`` seam, the solve through its
    powers.

    ``which="smallest"`` solves -A and negates the eigenvalues back.

    ``polish`` > 0 runs that many f64 block-Krylov Rayleigh-Ritz passes on
    the converged block (solvers.polish): on the operator's device when
    the raw input is DIA-representable and unpermuted (against the solve
    planes upcast on the device when they hold the raw values exactly),
    on the host (the native OpenMP CSR SpMM in f64) otherwise
    (``_polish_block``), then up to ``_SETTLE_PASSES`` more while a wanted
    pair's residual stays above the f32 level (``_polish_settled``):
    ``converged`` is False for a pair that does not settle.  ``over_lock``
    locks that many EXTRA pairs during the solve so the polish can discard
    sloppy directions and still return ``cfg.n_wanted`` accurate pairs.

    TF32 is switched off for matmuls and cuDNN (process-wide PyTorch
    flags): the f32 Gram products must not round to TF32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or LanczosConfig()
    times: Dict[str, float] = {}
    route = None
    raw = None  # the caller's raw matrix (the f64 source for the polish)
    with span("solve_auto", next(_CALLS)):
        with stage("route", times, A.device if hasattr(A, "matvec") else device):
            if not hasattr(A, "matvec"):
                from ca_lanczos_tpu_torch.ops.formats import make_operator

                raw = A
                with span("route.build"):
                    A, route = make_operator(A, device=device, **route_kwargs)
                with span("route.copy"):
                    r = torch.as_tensor(route.apply(np.asarray(r)), dtype=A.dtype,
                                        device=A.device)
            else:
                r = torch.as_tensor(r, dtype=A.dtype, device=A.device)
        dev = A.device
        if polish > 0 or over_lock > 0:
            from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

            if raw is None and not isinstance(A, DiaMatrix):
                raise ValueError(
                    "polish/over_lock need an f64 operator source: pass the "
                    "raw scipy matrix to solve_auto, or a DiaMatrix operator"
                )
        n_want0 = cfg.n_wanted
        if over_lock:
            cfg = dataclasses.replace(cfg, n_wanted=cfg.n_wanted + over_lock)
        if which not in ("largest", "smallest"):
            raise ValueError(f"which must be 'largest' or 'smallest', got {which!r}")
        if which == "smallest":
            from ca_lanczos_tpu_torch.ops.formats import negate_operator

            A = negate_operator(A)
        with stage("probe", times, dev):
            rec = recommend_solver(A, n_wanted=cfg.n_wanted, probe_steps=probe_steps)
        first = rec["driver"]
        second = (
            "impl_restarted_ca_lanczos" if first == "restarted_ca_lanczos"
            else "restarted_ca_lanczos"
        )
        with stage("solve", times, dev):
            res, solver, escalated = _escalate(
                lambda name, c, m: _run(name, A, r, m or max_lanczos, c, engine,
                                        cycles_per_call),
                _ladder(cfg, first, second, max_lanczos),
            )
        Q = res.Q_conv
        if route is not None and route.perm is not None and Q is not None:
            Q = route.restore(Q)
        eigs = np.asarray(res.eigs)
        presid = None
        converged, passes = bool(res.converged), 0
        if polish > 0 and Q is not None and Q.shape[1] > 0:
            # Polish in the ORIGINAL frame against the f64 source; the solve
            # frame's negation (which="smallest") is re-applied so the RR
            # keeps the wanted end.
            with stage("polish", times, dev):
                w, presid, Qp, passes, settled = _polish_settled(
                    raw, A, route, Q, which, polish, polish_depth, n_want0)
            keep = min(n_want0, len(w))
            eigs, presid = w[:keep], presid[:keep]
            Q = Qp[:, :keep]
            solver = solver + f"+polish{polish}"
            converged = converged and settled
        if which == "smallest":
            eigs = -eigs
        return AutoResult(
            eigs=eigs,
            Q_conv=Q,
            converged=converged,
            n_restarts=int(res.n_restarts),
            solver=solver,
            escalated=escalated,
            route=route,
            polish_resid=presid,
            polish_passes=passes,
            stage_seconds=times,
        )


def _settled(resid, keep: int, norm: float) -> bool:
    """True when each of the first ``keep`` pairs' residual lies within
    ``_SETTLE`` u ``norm`` (the f32 level, see ``_SETTLE``)."""
    return bool(np.all(np.asarray(resid)[:keep] <= _SETTLE * 2.0**-24 * norm))


def _polish_settled(raw, A_solve, route, Q, which, iters: int, depth: int, keep: int,
                    device="cuda"):
    """``_polish_block``, then at most ``_SETTLE_PASSES`` further passes
    at twice ``depth`` while one of the first ``keep`` pairs has not
    settled (``_settled``): at ``depth`` the Ising chain's unsettled
    blocks took three times the passes and stopped three times higher
    (CPU, 8,192 and 65,536 rows).  A block that reaches the f32 level
    within ``iters`` passes is polished exactly as by ``_polish_block``.
    Returns (w, resid, Q, passes run, settled)."""
    run, norm = _polish_operator(raw, A_solve, route, which, device)
    w, resid, Qp = run(Q, iters, depth)
    extra = 0
    while extra < _SETTLE_PASSES and not _settled(resid, keep, norm):
        with span("polish.settle", extra):
            w, resid, Qp = run(Qp, 1, 2 * depth)
        extra += 1
    return w, resid, Qp, max(int(iters), 1) + extra, _settled(resid, keep, norm)


def _polish_block(raw, A_solve, route, Q, which, iters: int, depth: int, device="cuda"):
    """f64 Rayleigh-Ritz polish of a converged block in the caller's
    frame (``_polish_operator``'s passes).  Returns (w desc-in-solve-frame,
    resid, Q (n, k) tensor) — w/resid aligned with Q's columns."""
    return _polish_operator(raw, A_solve, route, which, device)[0](Q, iters, depth)


def _polish_operator(raw, A_solve, route, which, device="cuda"):
    """The polish against the f64 operator of the first branch that
    applies, built once (counted in ``POLISH_PREP``; the ``polish.prep``
    span's args name it), as ``(run(Q, iters, depth), ||A||'s bound)``,
    the bound the largest absolute row sum:

    * ``device_upcast``: the solve operator's own DIA planes (already
      negated for ``which="smallest"``) upcast on their device, when
      they hold the raw matrix's values exactly (``_planes_hold_raw``),
      or when there is no raw matrix (representation-limited if the
      planes were stored f32);
    * ``host_dia``: f64 DIA planes of an unpermuted raw (host) matrix
      with at most ``_POLISH_MAX_DIAGS`` diagonals, built on the device
      from its CSR arrays (``ops.formats.dia_from_scipy``);
    * ``host_csr``: the native CSR SpMM in f64 on the host
      (``ops._spmm_native``): general sparsity, permuted routes.

    The device is the solve operator's, or ``device`` when there is none
    (the distributed solve polishes the gathered block against the raw
    matrix alone)."""
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.ops.formats import dia_from_scipy
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

    if isinstance(A_solve, DiaMatrix) and (raw is None or _planes_hold_raw(raw, A_solve, route)):
        POLISH_PREP["device_upcast"] += 1
        with span("polish.prep", "device_upcast"):
            A64 = DiaMatrix(data=A_solve.data.double(), offsets=A_solve.offsets)
        return _device_run(A64)
    dev = A_solve.device if A_solve is not None else torch.device(device)
    if raw is not None and (route is None or route.perm is None):
        with span("polish.prep", "host_dia"):
            csr = sp.csr_matrix(raw)
            if not csr.has_canonical_format:  # sum duplicates in f64, in a copy
                csr = csr.astype(np.float64)
            # None above the limit: scattered sparsity would materialize O(n^2) planes
            A64 = dia_from_scipy(csr, max_diags=_POLISH_MAX_DIAGS, waste_cap=np.inf,
                                 dtype=np.float64, device=dev)
            if A64 is not None and which == "smallest":
                A64.data.neg_()
        if A64 is not None:
            POLISH_PREP["host_dia"] += 1
            return _device_run(A64)
    from ca_lanczos_tpu_torch.ops._spmm_native import CsrMatmul

    POLISH_PREP["host_csr"] += 1
    with span("polish.prep", "host_csr"):
        csr = sp.csr_matrix(raw).astype(np.float64)
        mm = CsrMatmul(csr)
        norm = float(np.max(abs(csr).sum(axis=1)))
    matvec = (lambda Z: -mm(Z)) if which == "smallest" else mm

    def run(Q, iters, depth):
        from ca_lanczos_tpu_torch.solvers.polish import rayleigh_ritz_polish_host

        w, resid, Qp = rayleigh_ritz_polish_host(matvec, Q, iters=iters, depth=depth)
        return w, resid, torch.from_numpy(Qp)

    return run, norm


def _device_run(A64):
    """(``run(Q, iters, depth)``: the device polish against the DIA
    planes ``A64``; their largest absolute row sum)."""

    def run(Q, iters, depth):
        from ca_lanczos_tpu_torch.solvers.polish import rayleigh_ritz_polish

        return rayleigh_ritz_polish(A64, Q, iters=iters, depth=depth)

    return run, float(A64.data.abs().sum(dim=0).max())


def _planes_hold_raw(raw, A, route) -> bool:
    """True when the route's DIA planes ``A``, upcast to f64, are bit for
    bit the f64 planes of ``raw``: an unpermuted route, a raw dtype the
    planes hold exactly, no duplicate entries left in ``raw`` that the
    route summed in the planes' dtype (the f64 build sums them in f64),
    and at most ``_POLISH_MAX_DIAGS`` diagonals."""
    import scipy.sparse as sp

    planes = {torch.float32: np.float32, torch.float64: np.float64}.get(A.data.dtype)
    dtype = raw.dtype if sp.issparse(raw) else np.asarray(raw).dtype
    return (route is not None and route.perm is None and planes is not None
            and np.can_cast(dtype, planes, "safe")
            and getattr(raw, "nnz", route.nnz) == route.nnz
            and len(A.offsets) <= _POLISH_MAX_DIAGS)
