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


_M_LARGE = 96  # larger-basis rescue rung (see ladder)
_CALLS = itertools.count(1)  # numbers each solve_auto span of the process


def ladder(cfg: LanczosConfig, first: str, max_lanczos: Optional[int] = None):
    """Escalation ladder (same rungs as the TPU package): the probe's
    driver ``first`` and then the other one at the case's config, then
    full-orth, s=4 full-orth and m=96 rescue legs.  Returns [(driver,
    cfg, label, m_override), ...]."""
    second = ("impl_restarted_ca_lanczos" if first == "restarted_ca_lanczos"
              else "restarted_ca_lanczos")
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


def escalate(run, attempts):
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
    the converged block (``solvers.polish.polish_block``): on the
    operator's device when the raw input is DIA-representable and
    unpermuted (against the solve planes upcast on the device when they
    hold the raw values exactly), on the host (the native OpenMP CSR SpMM
    in f64) otherwise, then more while a wanted pair's residual stays
    above the f32 level: ``converged`` is False for a pair that does not
    settle.  ``over_lock`` locks that many EXTRA pairs during the solve so
    the polish can discard sloppy directions and still return
    ``cfg.n_wanted`` accurate pairs.

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
        with stage("solve", times, dev):
            res, solver, escalated = escalate(
                lambda name, c, m: _run(name, A, r, m or max_lanczos, c, engine,
                                        cycles_per_call),
                ladder(cfg, rec["driver"], max_lanczos),
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
            from ca_lanczos_tpu_torch.solvers.polish import polish_block

            with stage("polish", times, dev):
                eigs, presid, Q, passes, settled = polish_block(
                    raw, A, route, Q, which, polish, polish_depth, n_want0)
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
