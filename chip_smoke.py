#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phase 0  the card (nvidia-smi name and power limit), TF32 off; the CUDA
         kernels of ``ca_lanczos_tpu_torch/csrc`` (one nvcc per source, all
         started together) and the native PELL encoder (g++) built into
         build/.
Phase 1  each kernel against its plain PyTorch version on the card, f32 and
         f64: max error relative to max|plain| per vector (bounds 1e-5 f32,
         1e-12 f64; the sums run in another order), CUDA-event times (the
         median over 20 reps of a run of 10 back-to-back calls, over 10, so
         that the wrappers' host work overlaps the card's), the bound (bytes each input read once
         and each output written once over 3.35 TB/s, or operations over the
         peak rate, whichever is larger; for K4 the occupied slots only, the
         full planes printed beside them) and one torch.sparse CSR matvec of
         the same matrix as the library yardstick.  A kernel timed faster
         than its bound fails the run.
         K1-K3 at bench.py's operator (4,194,304 rows x 9 diagonals, s=8,
         Newton coefficients from the port's own bootstrap), and K1 again
         at main path A's (11,010,048 rows, tridiagonal, s=8; printed, not
         in the JSON line, with s x one CSR matvec of that matrix beside
         it); K1 and K3 do s steps, for which no single library call
         exists, so their library_ms is null and s x the CSR time is
         printed beside them.
         K4 and K5 on the planes of exp/pell_10m_e2e.py's operator
         (11,010,048 rows, encoded "unit", "auto" (it must pick grouped)
         and "grouped4").
Phase 2  main path A: ``solve_auto`` on the 11,010,048-row f32 flagship
         tridiagonal (exp/flagship_10m.py's matrix), prefer="dia" -> K1,
         polish=10, over_lock=3; checked against the committed oracle.
Phase 3  main path B: the same at 4,194,304 rows with prefer="auto" -> the
         interleaved route -> K3.
Phase C  main path C: ``solve_auto`` on the PELL oracle matrix (f32),
         prefer="pell", encoding="auto" -> grouped planes -> K5; checked
         against exp/pell_10m_oracle_11010048.npz.
Phase D  main path D: the same CSR with encoding="unit" -> K4.
Phase E  main path E: path A's matrix and settings at ``solve_auto``'s
         default engine ("host"): the reference's flagship driver,
         ``restarted_ca_lanczos`` (explicit restart, host control), powers
         through K1, every SpMV through K2.
Phase F  main path F: the IRL as first rung — the same recipe with a
         planted top cluster of 10 eigenvalues spaced 0.01 that decouples
         exactly (the probe finds it clustered), float64 (in float32 the
         IRL's s=8 CA extension breaks down, in the JAX package too),
         max_lanczos=48, default engine; checked against the planted
         values.

Phase G  the propagation workload (runLanczos.m).  (a) BASELINE's
         configuration: ``run_propagation_experiment(n=512, dt=0.025,
         n_steps=200, krylov_dim=24, s=6, tol=1e-10, device="cuda")``
         (std-lanczos, ca-newton, ca-monomial on the ELL harmonic
         oscillator) against the expm oracle (max |err| <= 1e-8 for
         std-lanczos, 1e-6 for the CA bases: the JAX package's ca-newton
         error here is 1.1e-7), and ``propagate_split_fused`` fixed and adaptive on
         the same input (<= 1e-8).  (b) The same physics at n = 4,194,304 on
         the DIA route (``make_operator(prefer="dia")`` of the oscillator's
         CSR: 9 diagonals, the periodic wrap at +-(n-1), +-(n-2); f64 planes,
         complex128 psi), dt = 0.025 normest(H_512)/normest(H_n): 20 time
         steps each of ``propagate`` lanczos and ca-newton,
         ``propagate_split`` and ``propagate_split_fused``; K2 by real and
         imaginary parts (the wrap leaves K1 no s-step window, so
         ``k1_plan_for`` gives "steps": the CA powers are K2 steps too).
         Norm drift <= 1e-10, the forms agree pairwise to 1e-8 (max |dpsi| /
         max |psi|), and 3 steps of lanczos on the kernel route equal them
         on the plain product to 1e-12 (``PlainOp``: the operator applied
         by ``DiaMatrix.matvec`` alone, no kernel launched); the CA powers
         (K2 steps by parts) at the run's Newton B are held step by step
         against the plain product (``check_powers``); ca-newton's 20 steps
         on the plain product are printed beside lanczos and the kernel
         route's ca-newton, or the time step where they break down.  (c) The hard-wall operator (the same 5 bands without
         the wrap; the packet is below 1e-31 at the walls): ``propagate``
         ca-newton, whose powers run K1 by parts, equals (b)'s ca-newton to
         1e-8; K1 by parts at this shape and the run's own Newton B is held
         step by step against the plain product (``check_powers``: each
         step's residual <= 1e-12 of its scale).  (The split CA propagator
         is left out: its Cholesky QR of the Newton basis breaks down at
         this ||H||, in the JAX package too.)
Phase H  BASELINE.json configs[4] on one card: exp/bsr_10m_e2e.py:59-84's
         planted block tridiagonal (rebuilt here with numpy; nb = 1,310,720
         block rows of 8x8, n = 10,485,760, f32, top values linspace(20,
         25, 16)).  (a) ``restarted_ca_lanczos(A, x, 16, LanczosConfig(s=4,
         n_wanted=3, tol=1e-4, max_restarts=30))`` on the ``BsrMatrix``
         (gather + einsum over the tiles) and on ``A.to_dia()`` (31
         diagonals inside +-15: K1's shared-memory fallback); each must
         converge with top-3 relative error <= 1e-6.  (b) ``sstep_lanczos``
         (s=4, m=3) on the DIA form in f64: its Ritz values equal full-orth
         ``lanczos`` over 12 steps to rtol 1e-5, and its monomial powers
         (f64 K1 at 31 diagonals) equal the plain recurrence to 1e-12 per
         column and step (``check_powers``).  The JAX package runs this
         configuration only through its ``parallel/`` drivers, which the
         port has not taken over yet; here it is the single-card host
         driver.  Phase 1 also prints K1 at this DIA shape for s in
         {2, 4, 8, 16} (configs[4]'s sweep) beside s x one BSR matvec of
         the port and s x one torch.sparse CSR matvec (and the BSR product
         as one torch.bmm of one column, for comparison).

Phases 2 and 3, C and D use engine="fused"; paths A-D check the label
"restarted_ca_lanczos+polish10", E the same at the host engine, F
"impl_restarted_ca_lanczos+polish10"; none may escalate.  Every launch
counter is set to 0 just before each main path (A-F, each form of G, each
route of H) and read just after it; a kernel's ``launches`` is the sum
over them.  Any failed check raises (exit code != 0).  The line before the
last is {"kernels": [...]}; the last is {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REPS = 20
BATCH = 10  # calls per timed run
BOUND = {"float32": 1e-5, "float64": 1e-12}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # outside the tensor cores
PELL_N = 11010048
BSR_NB = 1310720  # phase H: 10,485,760 rows of 8 x 8 tiles
PROP_N = 4194304  # phase G(b)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = REPS, warm: int = 3, batch: int = BATCH) -> float:
    """Device milliseconds per call of fn(): the median over reps of a run
    of ``batch`` back-to-back calls between two CUDA events, over batch.
    Within a run the host prepares the next call while the card runs the
    last, so only the first call's host work shows (1/batch of it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / batch)
    return float(np.median(ts))


def rel_err(torch, got, ref) -> float:
    """max over rows of max|got - ref| / max|ref| (rows = steps)."""
    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    num = (got - ref).abs().amax(dim=1)
    den = ref.abs().amax(dim=1)
    return float((num / den).max())


def bound_ms(nbytes: float, flops: float, dtype: str):
    """Least time for the work: bytes over the HBM rate or operations over
    the peak rate, the larger; returns (ms, "bytes" | "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def counters():
    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_pell, cuda_spmv

    return (cuda_spmv.LAUNCHES, cuda_ilv.LAUNCHES, cuda_pell.LAUNCHES)


def phase0(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from ca_lanczos_tpu_torch.ops import (
        _cuda_build,
        _pell_native,
        cuda_ilv,
        cuda_pell,
        cuda_spmv,
    )

    builds = {"dia_powers": cuda_spmv._lib, "ilv_powers": cuda_ilv._lib,
              "pell": cuda_pell._lib, "pell_encode (g++)": _pell_native.available}

    def build(item):
        t0 = time.perf_counter()
        out = item[1]()
        return item[0], out, time.perf_counter() - t0

    with ThreadPoolExecutor(len(builds)) as pool:
        done = list(pool.map(build, builds.items()))
    for name, out, secs in done:
        if name == "pell_encode (g++)":
            if not out:
                raise AssertionError("the native PELL encoder did not build or load")
            log(f"build {name}: {secs:.1f}s")
            continue
        log(f"build {name}: {secs:.1f}s -> {_cuda_build.library_path(name).name}")
        for line in _cuda_build.build_log(name).splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                log(f"  {line.strip()}")
    return smi


def csr_library(torch, csr, dtype):
    """The same matrix as a torch.sparse CSR tensor on the card (the
    yardstick of library_ms; the port never calls it)."""
    return torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype(np.int64)),
        torch.as_tensor(csr.indices.astype(np.int64)),
        torch.as_tensor(csr.data), size=csr.shape, dtype=dtype, device="cuda")


def check_bound(kname: str, dt: str, ms: float, bms: float) -> None:
    """A kernel cannot beat the least time its work takes: a reading above
    100% of the bound means the bytes or the timing are wrong."""
    if ms < bms:
        raise AssertionError(f"{kname} [{dt}] reads {bms / ms:.0%} of its bound "
                             f"({ms:.4f} ms < {bms:.4f} ms)")


def pell_bytes(torch, A):
    """(bytes a PELL step must move, bytes of the full planes + vectors).
    Unit encoding: the occupied prefix of each group's slots of vals, lidx
    and cbase, plus the per-group counts and span_row; grouped: every
    plane.  Both add x (n_x) and v_prev read once, y (n_pad) written once.
    The occupied prefix is taken from vals itself, so it counts what the
    function needs whichever kernel runs."""
    item = A.vals.element_size()
    vectors = (A.n_x + 2 * A.n_pad) * item
    full = sum(t.numel() * t.element_size()
               for t in (A.vals, A.lidx, A.cbase, A.span_row)) + vectors
    if A.enc != "unit":
        return full, full
    groups = A.ntiles * (A.tile // 128)
    occ = (A.vals.reshape(A.ntiles, A.k_slots, A.tile // 128, 128) != 0).any(dim=3)
    ordinal = torch.arange(1, A.k_slots + 1, device=occ.device)[None, :, None]
    slots = int((occ * ordinal).amax(dim=1).sum())
    need = (slots * (128 * (item + A.lidx.element_size()) + 4) + groups * 4
            + A.span_row.numel() * 4 + vectors)
    return need, full


def check_row(torch, kname, dt, got, ref):
    err = rel_err(torch, got, ref)
    abs_err = float((got - ref).abs().max())
    if not bool(torch.isfinite(got).all()) or not err <= BOUND[dt]:
        raise AssertionError(f"{kname} [{dt}] disagrees with its plain version: {err:.3e}")
    return err, abs_err


def bench_operator():
    """bench.py:123-134: 4,194,304 rows x 9 diagonals (-4..4), f32 planes,
    a unit x and a random v_prev (numpy)."""
    n, offsets = 1 << 22, tuple(range(-4, 5))
    nd = len(offsets)
    rng = np.random.default_rng(0)
    data = np.asarray(rng.standard_normal((nd, n)), np.float32) * 0.02
    data[nd // 2] += 0.8
    x = np.asarray(rng.standard_normal(n), np.float32)
    x /= np.linalg.norm(x)
    vprev = np.asarray(rng.standard_normal(n), np.float32)
    return data, offsets, x, vprev


def path_a_operator():
    """Main path A's matrix as DIA planes (exp/flagship_10m.py:47-53 at
    11,010,048 rows: the planted-top tridiagonal, the same numbers as
    :func:`flagship`), f32, and a random unit x (numpy)."""
    n = 11010048
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = np.linspace(95.0, 100.0, 10)
    off = np.random.default_rng(0).standard_normal(n) * 1e-3
    data = np.zeros((3, n), np.float32)
    data[0, 1:] = off[:-1]  # A[i, i-1]
    data[1] = d
    data[2, :-1] = off[:-1]  # A[i, i+1]
    x = np.asarray(np.random.default_rng(1).standard_normal(n), np.float32)
    x /= np.linalg.norm(x)
    return data, (-1, 0, 1), x


def newton_coefs(torch, data, offsets, x, s):
    """(s, 2) Newton coefficients as the main path makes them (the port's
    2s-step bootstrap, f64 on the card)."""
    from ca_lanczos_tpu_torch.config import Basis
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
    from ca_lanczos_tpu_torch.solvers.ca_lanczos import build_basis_matrix

    A64 = DiaMatrix(data=torch.as_tensor(data, dtype=torch.float64, device="cuda"),
                    offsets=offsets)
    Bk = build_basis_matrix(A64, torch.as_tensor(x, dtype=torch.float64, device="cuda"),
                            s, Basis.NEWTON)
    coefs = np.zeros((s, 2))
    coefs[:, 0] = np.diagonal(Bk)[:s]
    coefs[1:, 1] = np.diagonal(Bk, 1)[: s - 1]
    return coefs


def phase1_dia(torch):
    """K1-K3 vs plain versions; returns the f32 rows for the JSON line."""
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_spmv
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

    s = 8
    data, offsets, x, vprev = bench_operator()
    nd, n = data.shape
    nnz = sum(n - abs(o) for o in offsets)
    coefs = newton_coefs(torch, data, offsets, x, s)
    log(f"newton coefs: shifts {np.round(coefs[:, 0], 4).tolist()} "
        f"subs {np.round(coefs[:, 1], 6).tolist()}")
    # the library yardstick: one CSR matvec of the same matrix, f32
    rows = [np.arange(max(0, -o), min(n, n - o)) for o in offsets]
    csr = sp.csr_matrix((np.concatenate([data[d, r] for d, r in enumerate(rows)]),
                         (np.concatenate(rows),
                          np.concatenate([r + o for r, o in zip(rows, offsets)]))), (n, n))
    Acsr = csr_library(torch, csr, torch.float32)
    xl = torch.as_tensor(x, device="cuda")
    csr_ms = time_ms(torch, lambda: Acsr @ xl)
    log(f"library: torch.sparse CSR f32 matvec (n={n}, nnz={csr.nnz}) {csr_ms:.4f} ms; "
        f"s x CSR = {s * csr_ms:.4f} ms")
    del Acsr, csr, xl

    out = []
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        item = torch.empty((), dtype=dt).element_size()
        D = torch.as_tensor(data, dtype=dt, device="cuda")
        X = torch.as_tensor(x, dtype=dt, device="cuda")
        P = torch.as_tensor(vprev, dtype=dt, device="cuda")
        D_il = cuda_ilv.IlvDiaMatrix.from_dia(DiaMatrix(data=D, offsets=offsets),
                                              keep_dia=False).data_il
        X_il = cuda_ilv.ilv_encode(X).contiguous()
        # bytes: planes + x read, V (s, n) and last written; 2 flops per
        # nonzero and 4 per row for the shifts, per step
        powers_bytes = (nd + 1 + s + 1) * n * item
        powers_flops = s * (2 * nnz + 4 * n)
        cases = [
            ("dia_powers_fused", "ca_lanczos_tpu_torch/csrc/dia_powers.cu",
             "ca_lanczos_tpu/ops/pallas_spmv.py:403", s, powers_bytes, powers_flops, None,
             lambda: cuda_spmv.dia_powers_fused(D, X, coefs, offsets, s),
             lambda: cuda_spmv.dia_powers_fused_ref(D, X, coefs, offsets, s)),
            ("dia_power_step", "ca_lanczos_tpu_torch/csrc/dia_powers.cu",
             "ca_lanczos_tpu/ops/pallas_spmv.py:113", 1, (nd + 3) * n * item,
             2 * nnz + 4 * n, csr_ms,
             lambda: cuda_spmv.dia_power_step(D, X, P, coefs[1], offsets),
             lambda: cuda_spmv.dia_power_step_ref(D, X, P, coefs[1], offsets)),
            ("dia_powers_ilv", "ca_lanczos_tpu_torch/csrc/ilv_powers.cu",
             "ca_lanczos_tpu/ops/pallas_ilv.py:301", s, powers_bytes, powers_flops, None,
             lambda: cuda_ilv.dia_powers_ilv(D_il, X_il, coefs, offsets, s),
             lambda: cuda_ilv.dia_powers_ilv_ref(D_il, X_il, coefs, offsets, s)),
        ]
        for kname, src, replaces, steps, nbytes, flops, lib_ms, kern, plain in cases:
            abs_err, ms, plain_ms, bms, by = dia_row(torch, kname, name, n, nd, nnz, steps,
                                                     nbytes, flops, kern, plain)
            if dt == torch.float32:
                out.append(dict(name=kname, route="cuda", source=src, replaces=replaces,
                                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                bound_by=by, library_ms=lib_ms))
        del D, X, P, D_il, X_il
    torch.cuda.empty_cache()

    # K1 at main path A's shape too (printed only: its JSON row is bench.py's)
    data, offsets, x = path_a_operator()
    nd, n = data.shape
    nnz = sum(n - abs(o) for o in offsets)
    coefs = newton_coefs(torch, data, offsets, x, s)
    rows = [np.arange(max(0, -o), min(n, n - o)) for o in offsets]
    csr = sp.csr_matrix((np.concatenate([data[d, r] for d, r in enumerate(rows)]),
                         (np.concatenate(rows),
                          np.concatenate([r + o for r, o in zip(rows, offsets)]))), (n, n))
    Acsr = csr_library(torch, csr, torch.float32)
    xl = torch.as_tensor(x, device="cuda")
    csr_ms = time_ms(torch, lambda: Acsr @ xl)
    log(f"library at path A's shape: torch.sparse CSR f32 matvec (n={n}, nnz={csr.nnz}) "
        f"{csr_ms:.4f} ms; s x CSR = {s * csr_ms:.4f} ms")
    del Acsr, csr, xl
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        item = torch.empty((), dtype=dt).element_size()
        D = torch.as_tensor(data, dtype=dt, device="cuda")
        X = torch.as_tensor(x, dtype=dt, device="cuda")
        dia_row(torch, "dia_powers_fused (path A)", name, n, nd, nnz, s,
                (nd + 1 + s + 1) * n * item, s * (2 * nnz + 4 * n),
                lambda: cuda_spmv.dia_powers_fused(D, X, coefs, offsets, s),
                lambda: cuda_spmv.dia_powers_fused_ref(D, X, coefs, offsets, s))
        del D, X
    torch.cuda.empty_cache()
    return out


def dia_row(torch, kname, name, n, nd, nnz, steps, nbytes, flops, kern, plain,
            plain_reps=REPS, plain_batch=BATCH):
    """Check one DIA kernel against its plain version, time both and log
    the line; returns (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        e0, a0 = check_row(torch, kname, name, got[0], ref[0])
        e1, a1 = check_row(torch, kname, name, got[1], ref[1])
        err, abs_err = max(e0, e1), max(a0, a1)
    else:
        err, abs_err = check_row(torch, kname, name, got, ref)
    del got, ref
    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=plain_reps, batch=plain_batch)
    bms, by = bound_ms(nbytes, flops, name)
    log(f"kernel {kname} [{name}] n={n} nd={nd} s={steps}: rel_err={err:.3e} "
        f"(bound {BOUND[name]:.0e}) abs_err={abs_err:.3e} "
        f"kernel {ms:.4f} ms ({nnz * steps / (ms * 1e-3) / 1e9:.1f} Gnnz/s) "
        f"plain {plain_ms:.4f} ms bound {bms:.4f} ms ({by}; {bms / ms:.0%} of it) "
        f"speedup over plain {plain_ms / ms:.2f}x")
    check_bound(kname, name, ms, bms)
    return abs_err, ms, plain_ms, bms, by


def pell_operator(n: int, bw: int = 8, k: int = 4, seed: int = 0):
    """exp/pell_10m_e2e.py:43-56: random columns inside a width-8 band (4
    per row, symmetrised) over a separated-top diagonal, f64 CSR."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = np.linspace(95.0, 100.0, 10)
    rows = np.repeat(np.arange(n), k)
    keys = rng.random((n, 2 * bw + 1))
    pick = np.argsort(keys, axis=1)[:, :k]  # k distinct offsets in [-bw, bw]
    cols = np.arange(n)[:, None] + (pick - bw)
    cols = np.clip(cols, 0, n - 1).ravel()
    vals = (rng.standard_normal(n * k) * 1e-3).ravel()
    off = sp.csr_matrix((vals, (rows, cols)), (n, n))
    a = off + off.T + sp.diags(d)
    a.sum_duplicates()
    return a.tocsr(), d


def phase1_pell(torch, a32):
    """K4/K5 vs the plain version on the PELL oracle matrix's planes,
    encoded "unit", "auto" (which must pick grouped, the encoding phase C
    routes to) and "grouped4", f32 and f64; returns the f32 rows of K4 and
    of K5 grouped."""
    from ca_lanczos_tpu_torch.ops import cuda_pell, pell

    n = a32.shape[0]
    Acsr = csr_library(torch, a32, torch.float32)
    rng = np.random.default_rng(7)
    x = np.asarray(rng.standard_normal(n), np.float32)
    vp = np.asarray(rng.standard_normal(n), np.float32)
    xl = torch.as_tensor(x, device="cuda")
    csr_ms = time_ms(torch, lambda: Acsr @ xl)
    log(f"library: torch.sparse CSR f32 matvec (n={n}, nnz={a32.nnz}) {csr_ms:.4f} ms")
    del Acsr, xl
    d, sb = 0.7, -0.3
    out = []
    for request in ("unit", "auto", "grouped4"):
        t0 = time.perf_counter()
        A32 = pell.PellMatrix.from_scipy(a32, encoding=request, native=True, device="cuda")
        torch.cuda.synchronize()
        enc = A32.enc
        log(f"encode {request} (native): {time.perf_counter() - t0:.2f}s K={A32.k_slots} "
            f"sw={A32.sw} n_win={A32.n_win} enc={enc}")
        if request == "auto" and enc != "grouped":
            raise AssertionError(f"encoding='auto' picked {enc!r}, expected 'grouped'")
        kname = "pell_step_unit" if enc == "unit" else "pell_step_grouped"
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[-1]
            A = A32 if dt == torch.float32 else dataclasses.replace(A32, vals=A32.vals.to(dt))
            X = torch.zeros(A.n_x, dtype=dt, device="cuda")
            P = torch.zeros_like(X)
            X[:n] = torch.as_tensor(x, dtype=dt, device="cuda")
            P[:n] = torch.as_tensor(vp, dtype=dt, device="cuda")
            kern = lambda: cuda_pell.pell_step(A, X, P, d, sb)  # noqa: E731
            plain = lambda: pell.pell_step_ref(A, X, P, d, sb)  # noqa: E731
            err, abs_err = check_row(torch, f"{kname}/{enc}", name, kern(), plain())
            ms = time_ms(torch, kern)
            plain_ms = time_ms(torch, plain)
            nbytes, full = pell_bytes(torch, A)
            bms, by = bound_ms(nbytes, 2 * a32.nnz + 4 * A.n_pad, name)
            log(f"kernel {kname} [{enc}, {name}] n={n} K={A.k_slots}: rel_err={err:.3e} "
                f"(bound {BOUND[name]:.0e}) abs_err={abs_err:.3e} kernel {ms:.4f} ms "
                f"({a32.nnz / (ms * 1e-3) / 1e9:.1f} Gnnz/s, "
                f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s) plain {plain_ms:.4f} ms "
                f"bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB; {bms / ms:.0%} of it; "
                f"full planes {full / 1e6:.1f} MB, {bound_ms(full, 0, name)[0]:.4f} ms) "
                f"library {csr_ms:.4f} ms")
            check_bound(f"{kname}/{enc}", name, ms, bms)
            if dt == torch.float32 and enc != "grouped4":
                out.append(dict(name=kname, route="cuda",
                                source="ca_lanczos_tpu_torch/csrc/pell.cu",
                                replaces="ca_lanczos_tpu/ops/pell.py:1030",
                                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                bound_by=by, library_ms=csr_ms))
            del A, X, P
        del A32
        torch.cuda.empty_cache()
    return out


def flagship(n: int):
    """exp/flagship_10m.py:47-53,62: the planted-top tridiagonal, f64."""
    import scipy.sparse as sp

    d = np.linspace(1.0, 90.0, n)
    d[-10:] = np.linspace(95.0, 100.0, 10)
    rng = np.random.default_rng(0)
    off = (rng.standard_normal(n) * 1e-3).astype(np.float64)
    a = sp.diags([off[:-1], d, off[:-1]], [-1, 0, 1], format="csr")
    exact = np.load(os.path.join(ROOT, "exp", f"flagship_10m_oracle_{n}.npz"))["exact"]
    return a, exact


def cluster(n: int):
    """Phase F's matrix: the flagship recipe with the top 10 diagonal
    entries replaced by a cluster 99 + 0.01 k (k = 0..9) and the
    off-diagonals of the last 11 rows set to 0, so that the last 10 rows
    and columns decouple and the top 10 eigenvalues are exactly those
    entries (the rest lie below 90.01).  f64; returns (a, exact desc)."""
    import scipy.sparse as sp

    d = np.linspace(1.0, 90.0, n)
    d[-10:] = 99.0 + 0.01 * np.arange(10)
    off = np.random.default_rng(0).standard_normal(n) * 1e-3
    off[n - 11:] = 0.0
    a = sp.diags([off[:-1], d, off[:-1]], [-1, 0, 1], format="csr")
    return a, d[-10:][::-1].copy()


def counted(torch, totals: dict, fn):
    """fn() with every launch counter set to 0 just before and read just
    after; adds the counts to ``totals``; returns (result, counts, wall s)."""
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: v for counts in counters() for k, v in counts.items()}
    for k, v in delta.items():
        totals[k] = totals.get(k, 0) + v
    return out, delta, wall


class PlainOp:
    """An operator applied by the plain PyTorch product alone: it is no
    ``DiaMatrix``, so neither ``spmv``'s kernel table nor the powers'
    kernel test (``matrix_powers._kernel_eligible``) takes it."""

    def __init__(self, A):
        self.A = A
        self.shape, self.dtype, self.device = A.shape, A.dtype, A.device

    def matvec(self, x):
        return self.A.matvec(x)


def zero_counters() -> None:
    for counts in counters():
        for k in counts:
            counts[k] = 0


def nonzero_counts() -> dict:
    return {k: v for counts in counters() for k, v in counts.items() if v}


def plain_run(fn):
    """fn() on ``PlainOp`` operators; fails if any kernel launched."""
    zero_counters()
    out = fn()
    if nonzero_counts():
        raise AssertionError(f"the plain witness launched kernels: {nonzero_counts()}")
    return out


def check_powers(torch, label: str, A, q, B: np.ndarray, powers,
                 fwd_bound: float = float("inf")) -> None:
    """``powers(A, q)`` (K1 or K2 steps; a complex q by parts) held against
    the plain product on the same inputs.  For each step k the residual
    V[:,k+1] - (A V[:,k] - B[k,k] V[:,k] - B[k-1,k] V[:,k-1]), the plain
    product applied to the kernel's own columns, must be <= 1e-12 of the
    step's scale max(|A| |V[:,k]| + |B[k,k]| |V[:,k]| + |B[k-1,k]| |V[:,k-1]|)
    (f64), and column 0 must be q.  The forward gap to ``powers(PlainOp(A),
    q)`` (per column, relative to its max) is printed beside it and held to
    ``fwd_bound``: with Newton shifts at ||A|| ~ 1e10 the basis amplifies
    the rounding of any one summation order (~1e-6 relative between two
    orders at a few million rows), so there that gap is no measure of the
    kernel and has no bound."""
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

    zero_counters()
    V = powers(A, q)
    torch.cuda.synchronize()
    used = nonzero_counts()
    Vp = plain_run(lambda: powers(PlainOp(A), q))
    s = V.shape[1] - 1
    absA = DiaMatrix(data=A.data.abs(), offsets=A.offsets)
    res, fwd = [], []
    for k in range(s):
        c0, c1 = float(np.real(B[k, k])), float(np.real(B[k - 1, k])) if k else 0.0
        prev = V[:, k - 1] if k else torch.zeros_like(q)
        r = V[:, k + 1] - (A.matvec(V[:, k]) - c0 * V[:, k] - c1 * prev)
        scale = absA.matvec(V[:, k].abs()) + abs(c0) * V[:, k].abs() + abs(c1) * prev.abs()
        res.append(float(r.abs().max() / scale.max()))
        fwd.append(float((V[:, k + 1] - Vp[:, k + 1]).abs().max() / Vp[:, k + 1].abs().max()))
    del absA
    log(f"{label}: kernel launches {used}; step residuals vs the plain product "
        + " ".join(f"{x:.2e}" for x in res) + " (bound 1e-12 of each step's scale); "
        "forward gap to the plain recurrence " + " ".join(f"{x:.2e}" for x in fwd)
        + (f" (bound {fwd_bound:.0e})" if np.isfinite(fwd_bound) else " (no bound)"))
    if not (used.get("dia_powers_fused", 0) + used.get("dia_power_step", 0) > 0
            and bool((V[:, 0] == q).all()) and max(res) <= 1e-12 and max(fwd) <= fwd_bound):
        raise AssertionError(f"{label}: launches {used}, step residuals {res}, forward {fwd}")


def main_path(torch, label: str, a, exact, fmt: str, launched, totals: dict,
              solver: str = "restarted_ca_lanczos+polish10", max_lanczos: int = 32,
              **kw) -> dict:
    """One solve_auto on the card with every launch counter set to 0 just
    before and read just after; adds the counts to ``totals``, checks the
    result (every key of ``launched`` launched) and returns the figures
    that are printed."""
    from ca_lanczos_tpu_torch.config import LanczosConfig
    from ca_lanczos_tpu_torch.harness.auto import solve_auto

    n = a.shape[0]
    torch.cuda.reset_peak_memory_stats()
    res, delta, wall = counted(torch, totals, lambda: solve_auto(
        a, np.ones(n), max_lanczos,
        LanczosConfig(n_wanted=10, s=8, tol=1e-4, max_restarts=200),
        polish=10, over_lock=3, device="cuda", **kw,
    ))
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = np.sort(np.asarray(res.eigs))[::-1]
    err = (float(np.max(np.abs(got - exact))) / abs(float(exact[0])) if len(got) == 10
           else float("inf"))
    Q = res.Q_conv
    log(f"{label}: route={res.route.format} solver={res.solver} converged={res.converged} "
        f"n_restarts={res.n_restarts} escalated={res.escalated}")
    log(f"{label}: stages " + " ".join(f"{k}={v:.2f}s" for k, v in res.stage_seconds.items())
        + f" total={wall:.2f}s")
    log(f"{label}: eig_rel_err={err:.3e} (bound 1e-6) "
        f"max_polish_resid/|A|={float(np.max(res.polish_resid)) / abs(float(exact[0])):.3e} "
        f"launches={delta}")
    log(f"{label}: peak device memory {peak:.2f} GiB")
    checks = {
        f"route.format == {fmt!r}": res.route.format == fmt,
        f"solver == {solver!r}": res.solver == solver,
        "not escalated": not res.escalated,
        "converged": res.converged,
        "eig_rel_err <= 1e-6": err <= 1e-6,
        "Q_conv (n, 10) finite": tuple(Q.shape) == (n, 10) and bool(torch.isfinite(Q).all()),
    }
    checks.update({f"{k} launched": delta[k] > 0 for k in launched})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{label} failed: {failed}")
    out = dict(restarts=res.n_restarts, stages=dict(res.stage_seconds), total=wall, peak=peak,
               err=err)
    del res, Q
    torch.cuda.empty_cache()
    return out


def planted_block_tridiag(nb: int, bs: int = 8, seed: int = 0):
    """exp/bsr_10m_e2e.py:59-84 in numpy: a block tridiagonal with dense
    SPD-ish tiles whose last 2 block rows are decoupled and diagonal, so
    the top spectrum is exactly the planted values.  Returns (vals (nb, 3,
    bs, bs) f32, cols (nb, 3) int64, top (2 bs,) f32)."""
    rng = np.random.default_rng(seed)
    n = nb * bs
    d = np.linspace(1.0, 10.0, n).astype(np.float32)
    top = np.linspace(20.0, 25.0, 2 * bs).astype(np.float32)
    d[-2 * bs:] = top
    vals = np.zeros((nb, 3, bs, bs), np.float32)
    cols = np.zeros((nb, 3), np.int64)
    D = rng.standard_normal((nb, bs, bs)).astype(np.float32) * 0.05
    diag_blocks = D @ np.transpose(D, (0, 2, 1))
    ii = np.arange(bs)
    diag_blocks[:, ii, ii] = d.reshape(nb, bs)
    diag_blocks[-2:] = 0.0
    diag_blocks[-2:, ii, ii] = d.reshape(nb, bs)[-2:]
    vals[:, 0] = diag_blocks
    C = rng.standard_normal((nb - 1, bs, bs)).astype(np.float32) * 0.1
    C[-3:] = 0.0  # decouple the planted tail
    vals[:-1, 1] = C
    vals[1:, 2] = np.transpose(C, (0, 2, 1))
    cols[:, 0] = np.arange(nb)
    cols[:, 1] = np.minimum(np.arange(nb) + 1, nb - 1)
    cols[:, 2] = np.maximum(np.arange(nb) - 1, 0)
    return vals, cols, top


def bsr_operator(torch, nb: int = BSR_NB):
    """Phase H's matrix as a BsrMatrix on the card, and its planted top."""
    from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix

    vals, cols, top = planted_block_tridiag(nb)
    return BsrMatrix(vals=torch.as_tensor(vals, device="cuda"),
                     cols=torch.as_tensor(cols, device="cuda")), top


def bsr_csr(torch, A):
    """The BSR as a torch.sparse CSR tensor on the card (the library
    yardstick; stored tiles row by row, block columns sorted)."""
    nb, kb, bm, bn = A.vals.shape
    order = torch.argsort(A.cols, dim=1)
    cols = torch.gather(A.cols, 1, order)
    vals = A.vals[torch.arange(nb, device="cuda")[:, None], order]
    col = (cols[:, None, :, None] * bn
           + torch.arange(bn, device="cuda")).expand(nb, bm, kb, bn).reshape(-1)
    crow = torch.arange(nb * bm + 1, device="cuda") * (kb * bn)
    return torch.sparse_csr_tensor(crow, col, vals.permute(0, 2, 1, 3).reshape(-1),
                                   size=(nb * bm, nb * bn))


def phase1_bsr(torch):
    """K1 at the DIA form of phase H's BSR (31 diagonals inside +-15, f32)
    for s in {2, 4, 8, 16}, beside s x one BSR matvec of the port and s x
    one torch.sparse CSR matvec (printed, not in the JSON line)."""
    from ca_lanczos_tpu_torch.ops import cuda_spmv

    t0 = time.perf_counter()
    A, _ = bsr_operator(torch)
    D = A.to_dia()
    torch.cuda.synchronize()
    nd, n = D.data.shape
    nnz = A.exact_nnz()
    log(f"BSR (phase H's matrix): n={n} tiles {tuple(A.vals.shape)} nnz={nnz}; DIA form "
        f"nd={nd} offsets {D.offsets[0]}..{D.offsets[-1]}; built in "
        f"{time.perf_counter() - t0:.1f}s")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n), dtype=torch.float32,
                        device="cuda")
    x /= torch.linalg.norm(x)
    csr = bsr_csr(torch, A)
    y0 = A.matvec(x)
    for name, y in (("BSR matvec", y0), ("CSR", csr @ x), ("DIA K2", cuda_spmv.dia_matvec(D, x))):
        err = float((y - D.matvec(x)).abs().max() / D.matvec(x).abs().max())
        if not err <= BOUND["float32"]:
            raise AssertionError(f"{name} of the BSR disagrees with its DIA form: {err:.3e}")
    nb, kb, bm, bn = A.vals.shape

    def bmm_matvec():  # the same product as one batched GEMM of one column
        xb = x.reshape(-1, bn, 1)[A.cols].reshape(nb * kb, bn, 1)
        return torch.bmm(A.vals.reshape(nb * kb, bm, bn), xb).reshape(nb, kb, bm).sum(1)

    bsr_ms = time_ms(torch, lambda: A.matvec(x))
    bmm_ms = time_ms(torch, bmm_matvec)
    csr_ms = time_ms(torch, lambda: csr @ x)
    log(f"library at the BSR's shape: port BSR matvec (gather + einsum) "
        f"{bsr_ms:.4f} ms, the same as one torch.bmm of one column {bmm_ms:.4f} ms, "
        f"torch.sparse CSR f32 matvec (nnz={csr.values().numel()}) {csr_ms:.4f} ms")
    del csr, y0
    torch.cuda.empty_cache()
    item = 4
    for s in (2, 4, 8, 16):
        plan = cuda_spmv.k1_plan_for(D.offsets, s, torch.float32)
        coefs = newton_coefs(torch, D.data, D.offsets, x, s)
        dia_row(torch, f"dia_powers_fused (BSR DIA, {plan.variant} tile {plan.tile})",
                "float32", n, nd, nnz, s, (nd + 1 + s + 1) * n * item,
                s * (2 * nnz + 4 * n),
                lambda: cuda_spmv.dia_powers_fused(D.data, x, coefs, D.offsets, s),
                lambda: cuda_spmv.dia_powers_fused_ref(D.data, x, coefs, D.offsets, s),
                plain_reps=3, plain_batch=1)
        log(f"  beside K1 at s={s}: s x BSR matvec {s * bsr_ms:.4f} ms, "
            f"s x CSR {s * csr_ms:.4f} ms")
    del A, D, x
    torch.cuda.empty_cache()


def _k12(delta: dict) -> str:
    return f"K1 {delta['dia_powers_fused']} K2 {delta['dia_power_step']}"


def phase_g(torch, totals: dict, n_big: int = PROP_N):
    """The propagation workload (module docstring, phase G)."""
    import scipy.linalg
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.harness.experiments import run_propagation_experiment
    from ca_lanczos_tpu_torch.ops.cuda_spmv import k1_plan_for
    from ca_lanczos_tpu_torch.ops.formats import make_operator
    from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers_from_B
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, normest
    from ca_lanczos_tpu_torch.solvers import propagators as P
    from ca_lanczos_tpu_torch.utils.matrices import gaussian_packet, harmonic_oscillator

    # (a) BASELINE's configuration
    dt, steps = 0.025, 200
    recs, delta, wall = counted(torch, totals, lambda: run_propagation_experiment(
        n=512, dt=dt, n_steps=steps, krylov_dim=24, s=6, tol=1e-10, device="cuda"))
    # ca-newton: over 200 steps at n = 512 the JAX package's own error is
    # 1.1e-7 (its 1e-8 holds at 20 steps, n = 128); tests/test_torch_experiments.py
    # holds the port to it on the CPU.
    bounds = {"std-lanczos": 1e-8, "ca-newton": 1e-6, "ca-monomial": 1e-6}
    for r in recs:
        err = r.extra["max_abs_err"]
        log(f"G(a) {r.solver}: max_abs_err={err:.3e} (bound {bounds[r.solver]:.0e}) "
            f"wall {r.wall_s:.2f}s ({r.wall_s / steps * 1e3:.2f} ms per time step)")
        if not err <= bounds[r.solver]:
            raise AssertionError(f"G(a) {r.solver}: max_abs_err {err:.3e}")
    H, x = harmonic_oscillator(512, device="cuda")
    psi0 = torch.as_tensor(gaussian_packet(x), dtype=torch.complex128, device="cuda")
    ref = scipy.linalg.expm(-1j * dt * steps * H.to_dense().cpu().numpy()) @ psi0.cpu().numpy()
    for label, fn in (
            ("fixed", lambda: (P.propagate_split_fused(H, psi0, dt, steps, 24), steps * 24)),
            ("adaptive", lambda: P.propagate_split_fused_steps(H, psi0, dt, steps, 24, 1e-10))):
        (psi, krylov), _, wall = counted(torch, totals, fn)
        err = float(np.max(np.abs(psi.cpu().numpy() - ref)))
        log(f"G(a) propagate_split_fused {label}: max_abs_err={err:.3e} (bound 1e-08) "
            f"Krylov steps {krylov} wall {wall:.2f}s ({wall / steps * 1e3:.2f} ms per time step)")
        if not err <= 1e-8:
            raise AssertionError(f"G(a) propagate_split_fused {label}: max_abs_err {err:.3e}")

    # (b) the same physics at n_big on the DIA route
    t0 = time.perf_counter()
    He, xb = harmonic_oscillator(n_big, device="cpu")
    rows = np.repeat(np.arange(n_big), He.vals.shape[1])
    csr = sp.csr_matrix((He.vals.numpy().ravel(), (rows, He.cols.numpy().ravel())),
                        (n_big, n_big))
    Hb, route = make_operator(csr, prefer="dia", device="cuda")
    del He, csr
    dtb = dt * normest(H) / normest(Hb)
    psib = torch.as_tensor(gaussian_packet(xb), dtype=torch.complex128, device="cuda")
    nrm0 = float(torch.linalg.norm(psib))
    log(f"G(b) operator: n={n_big} route={route.format} nd={len(Hb.offsets)} "
        f"offsets {Hb.offsets} {Hb.dtype}; dt={dtb:.6e}; K1 plan at s=6: "
        f"{k1_plan_for(Hb.offsets, 6, Hb.dtype).variant}; built in "
        f"{time.perf_counter() - t0:.1f}s")
    nb_steps = 20
    forms = {
        "propagate lanczos": lambda: P.propagate(Hb, psib, dtb, nb_steps, 24, "lanczos"),
        "propagate ca-newton": lambda: P.propagate(Hb, psib, dtb, nb_steps, 24, "ca", s=6),
        "propagate_split": lambda: P.propagate_split(Hb, psib, dtb, nb_steps, 24),
        "propagate_split_fused": lambda: P.propagate_split_fused(Hb, psib, dtb, nb_steps, 24),
    }
    out = {}
    for label, fn in forms.items():
        psi, delta, wall = counted(torch, totals, fn)
        drift = float(torch.linalg.norm(psi)) / nrm0 - 1.0
        log(f"G(b) {label}: {wall / nb_steps * 1e3:.2f} ms per time step, Krylov steps "
            f"{24 * nb_steps}, drift {drift:.3e} (bound 1e-10), launches {_k12(delta)}")
        if not abs(drift) <= 1e-10 or not delta["dia_power_step"] > 0:
            raise AssertionError(f"G(b) {label}: drift {drift:.3e}, launches {delta}")
        out[label] = psi
    scale = float(out["propagate lanczos"].abs().max())
    names = list(out)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d = float((out[a] - out[b]).abs().max()) / scale
            log(f"G(b) {a} vs {b}: {d:.3e} (bound 1e-08)")
            if not d <= 1e-8:
                raise AssertionError(f"G(b) {a} vs {b} differ by {d:.3e}")
    moved = float((out["propagate lanczos"] - psib).abs().max()) / scale
    log(f"G(b) max |psi_T - psi_0| / max |psi| = {moved:.3e}")

    # comparisons with the plain product (PlainOp: no kernel at all, which
    # plain_run checks), outside counted(): not the main path's launches
    plain = PlainOp(Hb)
    p3 = plain_run(lambda: P.propagate(plain, psib, dtb, 3, 24, "lanczos"))
    d = float((P.propagate(Hb, psib, dtb, 3, 24, "lanczos") - p3).abs().max() / p3.abs().max())
    log(f"G(b) 3 lanczos steps, kernel route vs plain product: {d:.3e} (bound 1e-12)")
    if not d <= 1e-12:
        raise AssertionError(f"G(b) kernel route differs from the plain product: {d:.3e}")
    # the CA powers at this shape (K2 steps by parts), step by step
    Bk = P._newton_B(Hb, psib, 6, None)
    check_powers(torch, "G(b) K2 steps by parts, matrix_powers_from_B (s=6, complex128)", Hb,
                 psib / torch.linalg.norm(psib), Bk,
                 lambda A, q: matrix_powers_from_B(A, q, Bk))
    # ca-newton's 20 steps on the plain product, one time step a call
    psi = psib
    for k in range(nb_steps):
        try:
            psi = plain_run(lambda: P.propagate(plain, psi, dtb, 1, 24, "ca", s=6))
        except np.linalg.LinAlgError as e:
            log(f"G(b) propagate ca-newton on the plain product breaks down in time step "
                f"{k + 1}: {type(e).__name__}: {e} (printed only)")
            break
    else:
        d_l = float((psi - out["propagate lanczos"]).abs().max()) / scale
        d_k = float((psi - out["propagate ca-newton"]).abs().max()) / scale
        log(f"G(b) propagate ca-newton on the plain product: vs lanczos {d_l:.3e}, vs "
            f"ca-newton on the kernel route {d_k:.3e} (printed only)")
    del psi

    # (c) the hard-wall operator: the CA powers run K1 (by parts)
    keep = [i for i, o in enumerate(Hb.offsets) if abs(o) <= 2]
    Hw = DiaMatrix(data=Hb.data[keep].contiguous(), offsets=tuple(Hb.offsets[i] for i in keep))
    del Hb, plain
    psi, delta, wall = counted(torch, totals, lambda: P.propagate(Hw, psib, dtb, nb_steps, 24,
                                                                  "ca", s=6))
    drift = float(torch.linalg.norm(psi)) / nrm0 - 1.0
    d = float((psi - out["propagate ca-newton"]).abs().max()) / scale
    d_l = float((psi - out["propagate lanczos"]).abs().max()) / scale
    log(f"G(c) hard wall, propagate ca-newton: {wall / nb_steps * 1e3:.2f} ms per time step, "
        f"drift {drift:.3e}, vs G(b) ca-newton {d:.3e} (bound 1e-08), vs G(b) lanczos "
        f"{d_l:.3e} (printed only), launches {_k12(delta)}")
    if not (abs(drift) <= 1e-10 and d <= 1e-8 and delta["dia_powers_fused"] > 0):
        raise AssertionError(f"G(c): drift {drift:.3e} diff {d:.3e} {delta}")
    # K1 by parts at this run's shape and Newton B (its first time step's)
    Bk = P._newton_B(Hw, psib, 6, None)
    check_powers(torch, "G(c) K1 by parts, matrix_powers_from_B (s=6, complex128)", Hw,
                 psib / torch.linalg.norm(psib), Bk,
                 lambda A, q: matrix_powers_from_B(A, q, Bk))
    del Hw, out, psib, psi
    torch.cuda.empty_cache()


def phase_h(torch, totals: dict, nb: int = BSR_NB):
    """BASELINE.json configs[4] on one card (module docstring, phase H)."""
    from ca_lanczos_tpu_torch.config import LanczosConfig
    from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers_monomial
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
    from ca_lanczos_tpu_torch.solvers.lanczos import lanczos
    from ca_lanczos_tpu_torch.solvers.restarted import restarted_ca_lanczos
    from ca_lanczos_tpu_torch.solvers.sstep import sstep_lanczos

    t0 = time.perf_counter()
    A, top = bsr_operator(torch, nb)
    D = A.to_dia()
    torch.cuda.synchronize()
    n = A.n
    log(f"H operator: n={n} BSR {tuple(A.vals.shape)} "
        f"({A.vals.numel() * 4 / 1e9:.2f} GB), DIA nd={len(D.offsets)} "
        f"({D.data.numel() * 4 / 1e9:.2f} GB); built in {time.perf_counter() - t0:.1f}s")
    x = np.asarray(np.random.default_rng(1).standard_normal(n), np.float32)
    x /= np.linalg.norm(x)
    want = np.sort(top.astype(np.float64))[::-1][:3]
    cfg = LanczosConfig(s=4, n_wanted=3, tol=1e-4, max_restarts=30)
    for label, Op in (("BSR (gather)", A), ("DIA (K1)", D)):
        torch.cuda.reset_peak_memory_stats()
        res, delta, wall = counted(torch, totals, lambda: restarted_ca_lanczos(
            Op, torch.as_tensor(x, device="cuda"), 16, cfg))
        got = np.sort(np.asarray(res.eigs, np.float64))[::-1][:3]
        err = (float(np.max(np.abs(got - want)) / want[0]) if len(got) == 3
               else float("inf"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"H(a) restarted_ca_lanczos on {label}: converged={res.converged} "
            f"restarts={res.n_restarts} top3_rel_err={err:.3e} (bound 1e-6) solve {wall:.2f}s "
            f"peak {peak:.2f} GiB launches {_k12(delta)}")
        if not (res.converged and err <= 1e-6):
            raise AssertionError(f"H(a) {label}: converged={res.converged} err={err:.3e}")
        if Op is D and not delta["dia_powers_fused"] > 0:
            raise AssertionError("H(a): K1 not launched on the DIA route")
        del res
    del A
    D64 = DiaMatrix(data=D.data.double(), offsets=D.offsets)
    del D
    r = torch.as_tensor(x, dtype=torch.float64, device="cuda")
    (rs, rl), delta, wall = counted(torch, totals, lambda: (
        sstep_lanczos(D64, r, 4, 3), lanczos(D64, r, 12, orth="full")))
    ds = np.sort(np.linalg.eigvals(rs.T).real)
    dl = np.sort(np.linalg.eigvalsh(rl.T))
    rel = float(np.max(np.abs(ds - dl) / np.abs(dl)))
    log(f"H(b) sstep_lanczos (s=4, m=3, f64 DIA) vs full-orth lanczos(12): Ritz rel diff "
        f"{rel:.3e} (bound 1e-5); both {wall:.2f}s; top Ritz {ds[-3:]}; launches {_k12(delta)}")
    if not np.allclose(ds, dl, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"H(b) Ritz values differ: {rel:.3e}")
    # sstep's monomial powers at this shape (f64, 31 diagonals), from its p1
    p1 = r / torch.linalg.norm(r)
    check_powers(torch, "H(b) f64 monomial powers, matrix_powers_monomial (s=4)", D64, p1,
                 np.zeros((5, 4)), lambda A, q: matrix_powers_monomial(A, q, 4), fwd_bound=1e-12)
    del D64, r, rs, rl
    torch.cuda.empty_cache()


def phase(torch, name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    log(f"{name}: {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    if not os.path.isfile(os.path.join(ROOT, "ca_lanczos_tpu_torch", "__init__.py")):
        print("chip_smoke.py: run it from the root of a checkout "
              "(ca_lanczos_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device visible; this script needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t00 = time.perf_counter()

    t0 = time.perf_counter()
    phase0(torch)
    log(f"phase 0 (card, builds): {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    rows = phase1_dia(torch)
    a, _ = pell_operator(PELL_N)
    pell_exact = np.load(os.path.join(ROOT, "exp", f"pell_10m_oracle_{PELL_N}.npz"))["exact"]
    a32 = a.astype(np.float32)
    del a
    log(f"PELL oracle matrix: n={PELL_N} nnz={a32.nnz} built in "
        f"{time.perf_counter() - t0:.1f}s (from the start of phase 1)")
    rows += phase1_pell(torch, a32)
    phase1_bsr(torch)
    log(f"phase 1 (kernels vs plain): {time.perf_counter() - t0:.1f}s")

    totals: dict = {}
    fa, exact = flagship(11010048)
    fa32 = fa.astype(np.float32)
    del fa
    path_a = phase(torch, "phase 2", lambda: main_path(
        torch, "phase 2 (main path A, DIA/K1)", fa32, exact, "dia", ["dia_powers_fused"],
        totals, engine="fused", prefer="dia"))
    fb, exact_b = flagship(4194304)
    phase(torch, "phase 3", lambda: main_path(
        torch, "phase 3 (main path B, ilv/K3)", fb.astype(np.float32), exact_b, "ilv",
        ["dia_powers_ilv"], totals, engine="fused", prefer="auto"))
    del fb
    # phase 1 showed that encoding="auto" picks grouped on this matrix
    phase(torch, "phase C", lambda: main_path(
        torch, "phase C (main path C, PELL grouped/K5)", a32, pell_exact, "pell",
        ["pell_step_grouped"], totals, engine="fused", prefer="pell", encoding="auto"))
    phase(torch, "phase D", lambda: main_path(
        torch, "phase D (main path D, PELL unit/K4)", a32, pell_exact, "pell",
        ["pell_step_unit"], totals, engine="fused", prefer="pell", encoding="unit"))
    del a32
    path_e = phase(torch, "phase E", lambda: main_path(
        torch, "phase E (main path E, host restarted_ca_lanczos/K1+K2)", fa32, exact, "dia",
        ["dia_powers_fused", "dia_power_step"], totals, prefer="dia"))
    del fa32
    fc, exact_f = cluster(11010048)
    path_f = phase(torch, "phase F", lambda: main_path(
        torch, "phase F (main path F, IRL first rung, f64/K1)", fc, exact_f, "dia",
        ["dia_powers_fused"], totals, solver="impl_restarted_ca_lanczos+polish10",
        max_lanczos=48, prefer="dia"))
    del fc
    for label, p in (("A (fused)", path_a), ("E (host)", path_e), ("F (IRL, f64)", path_f)):
        log(f"paths side by side: {label}: restarts={p['restarts']} "
            + " ".join(f"{k}={v:.2f}s" for k, v in p["stages"].items())
            + f" total={p['total']:.2f}s peak={p['peak']:.2f} GiB eig_rel_err={p['err']:.3e}")
    phase(torch, "phase G", lambda: phase_g(torch, totals))
    phase(torch, "phase H", lambda: phase_h(torch, totals))

    for row in rows:
        row["launches"] = totals.get(row["name"], 0)
    idle = [row["name"] for row in rows if row["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels of the path not launched by the main paths: {idle}")
    log(f"total: {time.perf_counter() - t00:.1f}s")
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
