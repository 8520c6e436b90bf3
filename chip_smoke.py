#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phase 0  the card (nvidia-smi name and power limit), TF32 off; the CUDA
         kernels of ``ca_lanczos_tpu_torch/csrc`` (one nvcc per source, all
         started together), the native PELL encoder and the native
         Matrix Market parser (g++) built into build/.
Phase 1  each kernel against its plain PyTorch version on the card, f32 and
         f64: max error relative to max|plain| per vector (bounds 1e-5 f32,
         1e-12 f64; the sums run in another order), CUDA-event times (the
         median over 20 reps of a run of 10 back-to-back calls, over 10, so
         that the wrappers' host work overlaps the card's), the bound (bytes each input read once
         and each output written once over 3.35 TB/s, or operations over the
         peak rate, whichever is larger; for K4 and K5 the occupied slots
         only, the full planes printed beside them) and one torch.sparse CSR matvec of
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
         The tall-skinny triangular solve (csrc/tall_trsm.cu) at the CholQR
         blocks of ``TRSM_CASES`` (bound: the block read once and written
         once), torch.linalg.solve_triangular as its library yardstick.
Phase S  the host polish's SpMM: ``ops._spmm_native.CsrMatmul`` (the
         OpenMP product of ``csrc/host_spmm.cpp``, built with g++ in phase
         0) against scipy's ``a @ X`` on phase C's matrix in f64, as
         ``solvers.polish.f64_operator`` passes it (the f32 CSR upcast;
         11,010,048 rows, 84,156,726 nnz), at k = 13 (the polish's Q and B
         panels) and k = 65 (its depth-4 Z panel): per column j, max_i
         |Y_ij - (a @ X)_ij| <= 1e-15 max|a| max_i |X_ij| (bit for bit
         expected).  Printed: the median seconds of 5 applies of each, the
         host's CPU model, ``os.cpu_count()`` and ``torch.get_num_threads()``
         (the SpMM's thread count).  The polish's host branch (path B: the
         interleaved route's permutation) must run it: its applies count
         as ``csr_spmm_host`` among the launches of each path.
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
         diagonals inside +-15: K1's wide-band kernel); each must
         converge with top-3 relative error <= 1e-6.  (b) ``sstep_lanczos``
         (s=4, m=3) on the DIA form in f64: its Ritz values equal full-orth
         ``lanczos`` over 12 steps to rtol 1e-5, and its monomial powers
         (f64 K1 at 31 diagonals) equal the plain recurrence to 1e-12 per
         column and step (``check_powers``).  The JAX package runs this
         configuration only through its ``parallel/`` drivers; here it is
         the single-card host driver, and phase K(c) runs the distributed
         ones.  Phase 1 also prints K1 at this DIA shape for s in
         {2, 4, 8, 16} (configs[4]'s sweep) beside s x one BSR matvec of
         the port and s x one torch.sparse CSR matvec (and the BSR product
         as one torch.bmm of one column, for comparison); its s = 4 row
         (phase H's solves) is the JSON line's "dia_powers_band", K1's
         wide-band kernel, which H(a)'s DIA route, one corpus member of
         I(b) and K(c)'s s-step solve must launch.
Phase I  the file-in entry.  (a) Phase 3's matrix in float64
         (``flagship(4194304)``) written with the port's ``save_mtx(...,
         symmetric=True)`` (8,388,607 stored entries) into a temporary
         directory (TMPDIR; deleted at the end of the phase), read back by
         ``load_mtx`` alone and timed (the native parser must do it: the
         Python fallback's warning fails the run), then solved through the
         CLI in-process, so that the launch counters see its kernels:
         ``__main__.main(["solve", "--mtx", path, "--n-wanted", "10", "--s",
         "8", "--max-lanczos", "32", "--tol", "1e-4", "--polish", "10",
         "--over-lock", "3", "--engine", "fused", "--out", rec])``.  The
         record must read n = 4,194,304, nnz = 12,582,910, format "dia"
         (an f64 source stays DIA), not reordered, solver
         "restarted_ca_lanczos+polish10", not escalated, converged, with K1
         and K2 launched and max |eig - oracle| / 100 <= 1e-8 over the top
         10 (exp/flagship_10m_oracle_4194304.npz; ||A|| = 100).  K1 (s=8,
         Newton coefficients) and K2 at the solve's shape (the file's f64
         planes) are held against their plain versions (1e-12) and timed.
         One ``python -m ca_lanczos_tpu_torch info --mtx`` subprocess on a
         500-row file must exit 0 with one JSON record.  (b) The 23 members
         of ``build_corpus(small=False)`` through ``solve_auto(A, r, 60,
         LanczosConfig(s=6, orth=Orth.FULL, n_wanted=10, tol=1e-8,
         max_restarts=100))`` (exp/corpus_routed.py's settings; r =
         default_rng(0).random(n)): each converges, its top-10
         nearest-eigenvalue error <= 1e-6 of max |exact top|.  Before each
         DIA member's solve, K1 (s=6, the member's own Newton coefficients;
         unless its plan is K2 steps) and K2 on its planes are held against
         their plain versions (f64 1e-12): n <= 1000 with smem halos up to
         600 rows, the edges of the staging.  (c) On
         bench.py's operator: ``measure_powers_throughput(A, s=8)`` (a K2
         chain) and ``roofline_audit`` of its rate (fraction_of_peak <=
         1.05: the unfused step's model is a lower bound on its bytes),
         ``measure_ca_iteration_throughput`` for "roll" (K1), "ilv" and
         "ilv_rm" (K3), printed beside phase 1's times; then ``python -m
         ca_lanczos_tpu_torch.bench`` as a subprocess: its last line must be
         one JSON object with bench.py's keys and a value > 0, and its K1
         rate is held against phase 1's K1 bound for the same bytes (K1
         reads the planes once per s steps, so the per-step model is no
         bound for it).
Phase J  the distributed layer (``ca_lanczos_tpu_torch.parallel``) on
         P = min(4, cards) ranks started by ``parallel.runtime.spawn``
         (NCCL, one card each; the rank work is ``parallel.smoke.
         phase_j_rank``), all three solves in one launch at path A's
         settings (n_wanted=10, s=8, tol=1e-4, max_restarts=200,
         polish=10, over_lock=3, r = ones) on 11,010,048 rows.  (a)
         ``dist_solve_auto`` on path A's f32 flagship: route "ilv" (K3 on
         each rank's padded interleaved domain), label
         "dist_restarted_ca_lanczos+polish10".  (b) ``dist_restarted_ca_
         lanczos`` on the same matrix with dist_format="dia" (K1 on each
         rank's halo-padded shard), n_wanted 13, then the f64 polish of
         the gathered block on rank 0.  (c) ``dist_solve_auto`` on phase
         F's clustered f64 matrix, max_lanczos=48: the probe must pick the
         IRL ("dist_impl_restarted_ca_lanczos+polish10"), natural engine,
         K1 in f64.  Each: not escalated, converged, max |eig - oracle| /
         ||A|| <= 1e-6 (the committed oracle; the planted values for (c)),
         the same eigenvalues on every rank.  Before each solve every rank
         holds each kernel that the solve runs on its shard (K3 at s = 8
         and at s = 1, the locking and true-residual products, on the
         interleaved engine; K1 at s = 8 and K2 on the natural engine, in
         the solve's dtype) at the shard's padded shape against the plain
         version (1e-5 f32, 1e-12 f64) and times both, beside one
         torch.sparse CSR matvec of the shard, and each must be launched by
         the solve;
         after it, the collectives of one CA block (exchanges, halo
         elements, all-reduces, all-gathers: ``parallel.comm``) and
         ``cross_device_consistency`` of the replicated R (must be 0).
         The ranks return their launch counts, which the totals add up.
         Restarts and stage seconds print beside paths A, E and F.  (d)
         ``python -m ca_lanczos_tpu_torch scaling --devices P
         --rows-per-device 11010048`` (the flagship's shard) and
         ``solve --mesh P --mtx`` on a 500-row tridiagonal this phase
         writes (TMPDIR), each a subprocess that must exit 0 with one JSON
         record (the solve: converged, top 3 within rtol 1e-7 of the dense
         oracle).
Phase K  the distributed layer's second slice: one ``parallel.runtime.
         spawn`` (NCCL, P = min(4, cards); the rank work is ``parallel.
         smoke.phase_k_rank``; its inputs are written to TMPDIR first).
         Each rank first holds every kernel its solves run at its own
         operands' shapes against the plain version (1e-5 f32, 1e-12 f64)
         and times it beside its bound and one torch.sparse CSR matvec of
         the same shard, and each must then be launched by its solve.
         (a) ``dist_solve_auto`` on phases C/D's PELL oracle matrix
         (11,010,048 rows, 84,156,726 nnz, f32, bandwidth 8) with
         max_diags=16 (17 diagonals: not DIA), so the route is "pell": a
         DistPell, K4 on each rank's unit-encoded window of n_local + 2 x
         64 rows; path A's recipe (n_wanted=10, s=8, tol=1e-4,
         max_restarts=200, polish=10, over_lock=3, max_lanczos=32); label
         "dist_restarted_ca_lanczos+polish10", converged, not escalated,
         max |eig - oracle| / ||A|| <= 1e-6.  K4 held at the window: the 8
         chained steps and the one-step product.  Printed: the route's and
         the window's encode seconds, restarts, stages, launches, peak
         memory, one CA block's collectives.  (b) ``dist_ca_lanczos`` (s=4,
         24 steps, monomial) on the same EllMatrix as a DistEll
         (dist_format="ell": the gather) and as a DistPell (K4 at s = 4):
         the top 10 Ritz values agree to 1e-5 of ||A||.  (c) BASELINE.json
         configs[4] through the distributed drivers (exp/bsr_10m_e2e.py:
         96-146): phase H's planted BSR (n = 10,485,760, 8x8 tiles, f32) as
         a DistBsr, ``dist_bsr_matrix_powers`` (s=4) timed beside the
         single card's BSR powers (and equal to them to 1e-5),
         ``dist_restarted_ca_lanczos(A, x, 16, LanczosConfig(s=4,
         n_wanted=3, tol=1e-4, max_restarts=30))`` (converged, top-3
         relative error <= 1e-6), and ``dist_sstep_lanczos`` (s=4, m=3) on
         its f64 DIA form (31 diagonals: K1's wide-band kernel, K2) against the single
         card's ``sstep_lanczos``: max |dT| / max |T| <= 1e-10.  (d)
         ``dist_propagate_split`` of phase G(b)'s oscillator (4,194,304
         rows) as a 5-offset circulant f64 DistDia (``periodic=True``,
         s_max=1; K2 a column on the padded shard), 20 time steps, Krylov
         24, G(b)'s dt, against the single card's ``propagate_split`` on
         G(b)'s operator: max |dpsi| / max |psi| <= 1e-8, norm drift <=
         1e-10.

Phases 2 and 3, C and D use engine="fused"; paths A-D check the label
"restarted_ca_lanczos+polish10", E the same at the host engine, F
"impl_restarted_ca_lanczos+polish10"; none may escalate.  Every launch
counter is set to 0 just before each main path (A-F, each form of G, each
route of H, the CLI solve, each corpus member and each profiling chain of
I, each solve of J and K in its rank's process) and read just after it; a
kernel's ``launches`` is the sum over them.
Any failed check raises (exit code != 0).  The line before the last is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.
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
FILE_N = 4194304  # phase I(a): the .mtx file


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = REPS, warm: int = 3, batch: int = BATCH) -> float:
    """Device milliseconds per call of fn() (``utils.profiling.cuda_event_ms``:
    the median over reps of ``batch`` back-to-back calls between two CUDA
    events, over batch)."""
    from ca_lanczos_tpu_torch.utils.profiling import cuda_event_ms

    return cuda_event_ms(fn, reps, warm, batch)


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
    """The kernels' launch counts and the host SpMM's apply count."""
    from ca_lanczos_tpu_torch.ops import _spmm_native, cuda_ilv, cuda_pell, cuda_spmv, cuda_trsm

    return (cuda_spmv.LAUNCHES, cuda_ilv.LAUNCHES, cuda_pell.LAUNCHES, cuda_trsm.LAUNCHES,
            _spmm_native.APPLIES)


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
        _spmm_native,
        cuda_ilv,
        cuda_pell,
        cuda_spmv,
        cuda_trsm,
    )

    from ca_lanczos_tpu_torch.utils import mmio

    builds = {"dia_powers": cuda_spmv._lib, "ilv_powers": cuda_ilv._lib,
              "pell": cuda_pell._lib, "tall_trsm": cuda_trsm._lib, "pell_encode (g++)": _pell_native.available,
              "mmio (g++)": mmio.native_available, "host_spmm (g++)": _spmm_native.available}

    def build(item):
        t0 = time.perf_counter()
        out = item[1]()
        return item[0], out, time.perf_counter() - t0

    with ThreadPoolExecutor(len(builds)) as pool:
        done = list(pool.map(build, builds.items()))
    for name, out, secs in done:
        if name.endswith("(g++)"):
            if not out:
                raise AssertionError(f"the native {name} did not build or load")
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


def path_a_operator(n: int = 11010048, dtype=np.float32):
    """Main path A's matrix as DIA planes (exp/flagship_10m.py:47-53 at
    11,010,048 rows: the planted-top tridiagonal, the same numbers as
    :func:`flagship`), f32, and a random unit x (numpy); phase I(a)'s file
    matrix at ``n`` = 4,194,304 in f64."""
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = np.linspace(95.0, 100.0, 10)
    off = np.random.default_rng(0).standard_normal(n) * 1e-3
    data = np.zeros((3, n), dtype)
    data[0, 1:] = off[:-1]  # A[i, i-1]
    data[1] = d
    data[2, :-1] = off[:-1]  # A[i, i+1]
    x = np.asarray(np.random.default_rng(1).standard_normal(n), dtype)
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


def check_dia_operator(torch, A, x, s: int) -> str:
    """K1 (when its plan is not K2 steps) and K2 on a path's own DiaMatrix
    ``A`` against their plain versions, with A's own Newton coefficients
    (``newton_coefs`` from x) and a random v_prev: :func:`check_row` at
    A's dtype bound (f64 1e-12).  Returns a log fragment; raises on a
    mismatch."""
    from ca_lanczos_tpu_torch.ops import cuda_spmv

    D, offsets = A.data, tuple(A.offsets)
    dt = str(D.dtype).split(".")[-1]
    X = torch.as_tensor(x, dtype=D.dtype, device="cuda")
    X = X / torch.linalg.norm(X)
    P = torch.as_tensor(np.random.default_rng(2).standard_normal(X.shape[0]), dtype=D.dtype,
                        device="cuda")
    coefs = newton_coefs(torch, D, offsets, x, s)
    plan = cuda_spmv.k1_plan_for(offsets, s, D.dtype).variant
    errs = []
    if plan != "steps":
        got = cuda_spmv.dia_powers_fused(D, X, coefs, offsets, s)
        ref = cuda_spmv.dia_powers_fused_ref(D, X, coefs, offsets, s)
        errs += [check_row(torch, f"dia_powers_fused ({plan})", dt, g, r)[0]
                 for g, r in zip(got, ref)]
    got = cuda_spmv.dia_power_step(D, X, P, coefs[1], offsets)
    errs.append(check_row(torch, "dia_power_step", dt, got,
                          cuda_spmv.dia_power_step_ref(D, X, P, coefs[1], offsets))[0])
    k1 = "K1 not launched (plan: K2 steps)" if plan == "steps" else f"K1 {plan} s={s} +"
    return f"{k1} K2 vs plain {max(errs):.1e} (bound {BOUND[dt]:.0e})"


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
    # the library yardstick: one CSR matvec of the same matrix, per dtype
    rows = [np.arange(max(0, -o), min(n, n - o)) for o in offsets]
    csr = sp.csr_matrix((np.concatenate([data[d, r] for d, r in enumerate(rows)]),
                         (np.concatenate(rows),
                          np.concatenate([r + o for r, o in zip(rows, offsets)]))), (n, n))

    out = []
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        Acsr = csr_library(torch, csr, dt)
        xl = torch.as_tensor(x, dtype=dt, device="cuda")
        csr_ms = time_ms(torch, lambda: Acsr @ xl)
        log(f"library: torch.sparse CSR {name} matvec (n={n}, nnz={csr.nnz}) {csr_ms:.4f} ms; "
            f"s x CSR = {s * csr_ms:.4f} ms")
        del Acsr, xl
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
    del csr
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
    rng = np.random.default_rng(7)
    x = np.asarray(rng.standard_normal(n), np.float32)
    vp = np.asarray(rng.standard_normal(n), np.float32)
    csr_ms = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        Acsr = csr_library(torch, a32, dt)
        xl = torch.as_tensor(x, dtype=dt, device="cuda")
        csr_ms[name] = time_ms(torch, lambda: Acsr @ xl)
        log(f"library: torch.sparse CSR {name} matvec (n={n}, nnz={a32.nnz}) "
            f"{csr_ms[name]:.4f} ms")
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
            nbytes, full = pell.pell_step_bytes(A)
            bms, by = bound_ms(nbytes, 2 * a32.nnz + 4 * A.n_pad, name)
            log(f"kernel {kname} [{enc}, {name}] n={n} K={A.k_slots}: rel_err={err:.3e} "
                f"(bound {BOUND[name]:.0e}) abs_err={abs_err:.3e} kernel {ms:.4f} ms "
                f"({a32.nnz / (ms * 1e-3) / 1e9:.1f} Gnnz/s, "
                f"{nbytes / (ms * 1e-3) / 1e12:.2f} TB/s) plain {plain_ms:.4f} ms "
                f"bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB; {bms / ms:.0%} of it; "
                f"full planes {full / 1e6:.1f} MB, {bound_ms(full, 0, name)[0]:.4f} ms) "
                f"library {csr_ms[name]:.4f} ms")
            check_bound(f"{kname}/{enc}", name, ms, bms)
            if dt == torch.float32 and enc != "grouped4":
                out.append(dict(name=kname, route="cuda",
                                source="ca_lanczos_tpu_torch/csrc/pell.cu",
                                replaces="ca_lanczos_tpu/ops/pell.py:1030",
                                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                bound_by=by, library_ms=csr_ms[name]))
            del A, X, P
        del A32
        torch.cuda.empty_cache()
    return out


TRSM_CASES = (  # (n, k, dtype, layout): the solve's and the polish's CholQR blocks
    (11010048, 9, "float32", "rows"), (11010048, 8, "float32", "rows"),
    (11010048, 13, "float32", "rows"), (11010048, 20, "float32", "rows"),
    (4194304, 9, "float32", "rows"), (4194304, 9, "float32", "cols"),
    (11010048, 9, "float64", "rows"))


def phase1_trsm(torch):
    """The tall-skinny triangular solve vs its plain version at the CholQR
    blocks of the benchmark's cells (the chain's fused solve (n, 9) and
    (n, 8), its polish (n, 13), the refine (n, 20), the Ising chain's
    (4,194,304, 9), column-major where the PELL powers hand it over) and
    one f64 case: X gaussian, R the upper Cholesky factor of X^T X as a
    CholQR pass makes it (``ops.qr._chol_safe``, a transposed view).
    Bound: X read once and Y written once; library: torch.linalg.
    solve_triangular; beside them the time of ``X.clone()``, the same
    bytes moved by a plain copy.  Returns the (11,010,048, 9) f32 row."""
    from ca_lanczos_tpu_torch.ops import cuda_trsm
    from ca_lanczos_tpu_torch.ops.qr import _chol_safe

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for n, k, name, lay in TRSM_CASES:
        dt = getattr(torch, name)
        X = torch.randn((k, n) if lay == "cols" else (n, k), generator=gen, device="cuda",
                        dtype=dt)
        X = X.T if lay == "cols" else X
        R = _chol_safe(X.T @ X).T
        kern = lambda: cuda_trsm.tall_trsm(X, R)  # noqa: E731
        plain = lambda: cuda_trsm.tall_trsm_ref(X, R)  # noqa: E731
        lib = lambda: torch.linalg.solve_triangular(R, X, upper=True, left=False)  # noqa: E731
        got, ref = kern(), plain()
        err, abs_err = check_row(torch, "tall_trsm", name, got.T, ref.T)
        lib_err = rel_err(torch, lib().T, ref.T)
        del got, ref
        ms, plain_ms, lib_ms = time_ms(torch, kern), time_ms(torch, plain), time_ms(torch, lib)
        copy_ms = time_ms(torch, lambda: X.clone())  # the same bytes moved by a plain copy
        nbytes = 2 * n * k * X.element_size()
        bms, by = bound_ms(nbytes, n * k * k, name)
        log(f"kernel tall_trsm [{name}, {lay}] n={n} k={k}: rel_err={err:.3e} "
            f"(bound {BOUND[name]:.0e}; library vs plain {lib_err:.3e}) abs_err={abs_err:.3e} "
            f"kernel {ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e12:.2f} TB/s) plain {plain_ms:.4f} ms "
            f"bound {bms:.4f} ms ({by}; {bms / ms:.0%} of it) library {lib_ms:.4f} ms "
            f"({bms / lib_ms:.0%} of the bound); X.clone() {copy_ms:.4f} ms "
            f"({bms / copy_ms:.0%})")
        check_bound("tall_trsm", name, ms, bms)
        if (n, k, name, lay) == TRSM_CASES[0]:
            out.append(dict(name="tall_trsm", route="cuda",
                            source="ca_lanczos_tpu_torch/csrc/tall_trsm.cu",
                            replaces="none (cuBLAS batch_trsm_right_kernel; the JAX package's "
                                     "solve is XLA's, ca_lanczos_tpu/ops/qr.py:66)",
                            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                            bound_by=by, library_ms=lib_ms))
        del X, R
    torch.cuda.empty_cache()
    return out


def host_cpu() -> str:
    """The host's CPU model: /proc/cpuinfo's "model name" (x86) or its CPU
    implementer and part (Arm), and the machine type."""
    import platform

    fields: dict = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            fields.setdefault(key.strip(), val.strip())
    name = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("CPU implementer", "CPU part") if k in fields)
    return f"{name or 'no model in /proc/cpuinfo'} ({platform.machine()})"


def phase_s(torch, a32) -> None:
    """The host polish's SpMM against scipy on path C's matrix (module
    docstring, phase S)."""
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.ops._spmm_native import CsrMatmul

    a = sp.csr_matrix(a32).astype(np.float64)
    mm = CsrMatmul(a)
    amax = float(np.abs(a.data).max())
    log(f"S host: {host_cpu()}; os.cpu_count()={os.cpu_count()} "
        f"torch.get_num_threads()={torch.get_num_threads()}")

    def median_s(fn):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)), out

    X65 = np.random.default_rng(11).random((a.shape[0], 65))
    failed = []
    for k in (13, 65):
        X = X65 if k == 65 else np.ascontiguousarray(X65[:, :k])
        t_native, got = median_s(lambda: mm(X))
        t_scipy, ref = median_s(lambda: a @ X)
        err = np.abs(got - ref).max(axis=0)
        bound = 1e-15 * amax * np.abs(X).max(axis=0)
        log(f"S CsrMatmul k={k} (n={a.shape[0]}, nnz={a.nnz}, f64): native {t_native:.4f} s "
            f"scipy {t_scipy:.4f} s an apply (median of 5; {t_scipy / t_native:.1f}x); "
            f"max|Y - a @ X| {float(err.max()):.3e} (bound 1e-15 max|a| max|X_j| per column, "
            f"the least {float(bound.min()):.3e}); bit for bit: {bool(np.array_equal(got, ref))}")
        if not (err <= bound).all():
            failed.append(k)
        del X, got, ref
    del X65
    if failed:
        raise AssertionError(f"phase S: the native SpMM disagrees with scipy at k = {failed}")


def flagship_planes(n: int):
    """exp/flagship_10m.py:47-53: the planted-top tridiagonal's diagonal d
    and couplings off (A[i, i+1] = A[i+1, i] = off[i]), f64."""
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = np.linspace(95.0, 100.0, 10)
    off = (np.random.default_rng(0).standard_normal(n) * 1e-3).astype(np.float64)
    return d, off


def flagship(n: int):
    """exp/flagship_10m.py:47-53,62: the planted-top tridiagonal, f64, and
    its committed oracle."""
    import scipy.sparse as sp

    d, off = flagship_planes(n)
    a = sp.diags([off[:-1], d, off[:-1]], [-1, 0, 1], format="csr")
    exact = np.load(os.path.join(ROOT, "exp", f"flagship_10m_oracle_{n}.npz"))["exact"]
    return a, exact


def cluster_planes(n: int):
    """Phase F's matrix: the flagship recipe with the top 10 diagonal
    entries replaced by a cluster 99 + 0.01 k (k = 0..9) and the
    off-diagonals of the last 11 rows set to 0, so that the last 10 rows
    and columns decouple and the top 10 eigenvalues are exactly those
    entries (the rest lie below 90.01).  f64; returns (d, off, exact desc)."""
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = 99.0 + 0.01 * np.arange(10)
    off = np.random.default_rng(0).standard_normal(n) * 1e-3
    off[n - 11:] = 0.0
    return d, off, d[-10:][::-1].copy()


def cluster(n: int):
    """:func:`cluster_planes` as a CSR matrix; returns (a, exact desc)."""
    import scipy.sparse as sp

    d, off, exact = cluster_planes(n)
    return sp.diags([off[:-1], d, off[:-1]], [-1, 0, 1], format="csr"), exact


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
    """fn() on ``PlainOp`` operators; fails if any operator kernel launched
    (its CholQR passes may run the triangular solve's kernel)."""
    zero_counters()
    out = fn()
    used = {k: v for k, v in nonzero_counts().items() if k != "tall_trsm"}
    if used:
        raise AssertionError(f"the plain witness launched kernels: {used}")
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
               err=err, applies=delta.get("csr_spmm_host", 0))
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
    one torch.sparse CSR matvec; returns the row of s = 4 (phase H's
    solve) for the JSON line as "dia_powers_band", K1's wide-band kernel
    (its own launch count; no single library call does s steps)."""
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
    out = []
    for s in (2, 4, 8, 16):
        plan = cuda_spmv.k1_plan_for(D.offsets, s, torch.float32)
        if plan.variant != "band":
            raise AssertionError(f"K1 at the BSR's DIA form, s={s}: plan {plan.variant!r}, "
                                 "expected the wide-band kernel")
        coefs = newton_coefs(torch, D.data, D.offsets, x, s)
        abs_err, ms, plain_ms, bms, by = dia_row(
            torch, f"dia_powers_fused (BSR DIA, {plan.variant} tile {plan.tile})",
            "float32", n, nd, nnz, s, (nd + 1 + s + 1) * n * item, s * (2 * nnz + 4 * n),
            lambda: cuda_spmv.dia_powers_fused(D.data, x, coefs, D.offsets, s),
            lambda: cuda_spmv.dia_powers_fused_ref(D.data, x, coefs, D.offsets, s),
            plain_reps=3, plain_batch=1)
        log(f"  beside K1 at s={s}: s x BSR matvec {s * bsr_ms:.4f} ms, "
            f"s x CSR {s * csr_ms:.4f} ms")
        if s == 4:
            out.append(dict(name="dia_powers_band", route="cuda",
                            source="ca_lanczos_tpu_torch/csrc/dia_powers.cu",
                            replaces="ca_lanczos_tpu/ops/pallas_spmv.py:403",
                            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                            bound_by=by, library_ms=None))
    del A, D, x
    torch.cuda.empty_cache()
    return out


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
        if Op is D and not delta["dia_powers_band"] > 0:
            raise AssertionError("H(a): K1's wide-band kernel not launched on the DIA route")
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


def phase_i(torch, totals: dict, rows: list, n_file: int = FILE_N) -> None:
    """The file-in entry, the corpus and the profiling tools (module
    docstring, phase I); ``rows`` are phase 1's f32 kernel rows."""
    import tempfile
    import warnings

    import scipy.sparse as sp

    from ca_lanczos_tpu_torch import __main__ as cli
    from ca_lanczos_tpu_torch.config import LanczosConfig, Orth
    from ca_lanczos_tpu_torch.harness.auto import solve_auto
    from ca_lanczos_tpu_torch.harness.corpus import build_corpus
    from ca_lanczos_tpu_torch.ops import cuda_spmv
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
    from ca_lanczos_tpu_torch.utils import mmio, profiling

    # (a) the file path at full size, in a temporary directory (never under
    # build/, which travels with copies of the checkout)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        a, exact = flagship(n_file)
        path = os.path.join(tmp, f"flagship_{n_file}.mtx")
        t0 = time.perf_counter()
        mmio.save_mtx(path, a, symmetric=True)
        t_write = time.perf_counter() - t0
        del a
        with open(path) as f:
            f.readline()
            stored = int(f.readline().split()[2])  # the lower triangle
        if not mmio.native_available():
            raise AssertionError("I(a): the native Matrix Market parser did not build")
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)  # the Python fallback warns
            ri, ci, vi, shape = mmio.load_mtx(path)
        t_parse = time.perf_counter() - t0
        log(f"I(a) save_mtx (symmetric) {n_file} rows: {stored} stored entries, "
            f"{os.path.getsize(path) / 1e9:.3f} GB in {t_write:.2f}s; native load_mtx "
            f"{len(vi)} entries in {t_parse:.2f}s")
        if stored != 2 * n_file - 1 or shape != (n_file, n_file) or len(vi) != 3 * n_file - 2:
            raise AssertionError(f"I(a): {stored} stored, parsed {shape}, {len(vi)} entries")
        del ri, ci, vi
        rec_path = os.path.join(tmp, "solve.json")
        argv = ["solve", "--mtx", path, "--n-wanted", "10", "--s", "8", "--max-lanczos", "32",
                "--tol", "1e-4", "--polish", "10", "--over-lock", "3", "--engine", "fused",
                "--out", rec_path]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rc, delta, wall = counted(torch, totals, lambda: cli.main(argv))
        rec = json.loads(open(rec_path).read())
        got = np.asarray(rec["eigs"])
        err = (float(np.max(np.abs(got - exact))) / abs(float(exact[0])) if len(got) == 10
               else float("inf"))
        log(f"I(a) python -m ca_lanczos_tpu_torch solve --mtx (in-process): rc={rc} "
            f"n={rec['n']} nnz={rec['nnz']} format={rec['format']} "
            f"reordered={rec['reordered']} solver={rec['solver']} escalated={rec['escalated']} "
            f"converged={rec['converged']} n_restarts={rec['n_restarts']} "
            f"eig_rel_err={err:.3e} (bound 1e-8) wall {wall:.2f}s launches {_k12(delta)}")
        fallback = [str(w.message) for w in caught if "pure-Python fallback" in str(w.message)]
        checks = {
            "rc == 0": rc == 0,
            f"n == {n_file}": rec["n"] == n_file,
            f"nnz == {3 * n_file - 2}": rec["nnz"] == 3 * n_file - 2,
            "format == 'dia'": rec["format"] == "dia",
            "not reordered": rec["reordered"] is False,
            "solver label": rec["solver"] == "restarted_ca_lanczos+polish10",
            "not escalated": rec["escalated"] is False,
            "converged": rec["converged"] is True,
            "eig_rel_err <= 1e-8": err <= 1e-8,
            "K1 launched": delta["dia_powers_fused"] > 0,
            "K2 launched": delta["dia_power_step"] > 0,
            "native parse": not fallback,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"I(a) failed: {failed} {fallback}")
        # K1 and K2 at the solve's shape (the file's planes, f64, s = 8)
        # against their plain versions; these launches are not the path's
        data, offsets, x = path_a_operator(n_file, np.float64)
        nd, nnz = len(offsets), sum(n_file - abs(o) for o in offsets)
        coefs = newton_coefs(torch, data, offsets, x, 8)
        D, X = torch.as_tensor(data, device="cuda"), torch.as_tensor(x, device="cuda")
        P = torch.roll(X, 1)
        del data
        dia_row(torch, "dia_powers_fused (I(a))", "float64", n_file, nd, nnz, 8,
                (nd + 1 + 8 + 1) * n_file * 8, 8 * (2 * nnz + 4 * n_file),
                lambda: cuda_spmv.dia_powers_fused(D, X, coefs, offsets, 8),
                lambda: cuda_spmv.dia_powers_fused_ref(D, X, coefs, offsets, 8))
        dia_row(torch, "dia_power_step (I(a))", "float64", n_file, nd, nnz, 1,
                (nd + 3) * n_file * 8, 2 * nnz + 4 * n_file,
                lambda: cuda_spmv.dia_power_step(D, X, P, coefs[1], offsets),
                lambda: cuda_spmv.dia_power_step_ref(D, X, P, coefs[1], offsets))
        del D, X, P
        # the module entry, as a user starts it
        small = os.path.join(tmp, "small.mtx")
        mmio.save_mtx(small, sp.diags([np.full(499, -1.0), np.linspace(1.0, 9.0, 500),
                                       np.full(499, -1.0)], [-1, 0, 1]), symmetric=True)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ca_lanczos_tpu_torch", "info", "--mtx",
                               small], cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        log(f"I(a) python -m ca_lanczos_tpu_torch info --mtx {os.path.basename(small)}: "
            f"rc={proc.returncode} in {time.perf_counter() - t0:.1f}s: {' | '.join(lines)}")
        if proc.returncode != 0 or len(lines) != 1 or json.loads(lines[0])["n"] != 500:
            raise AssertionError(f"I(a) info subprocess failed: {proc.stderr[-2000:]}")

    # (b) the corpus on the card at exp/corpus_routed.py's settings
    t0 = time.perf_counter()
    corpus = build_corpus(small=False, device="cuda")
    log(f"I(b) build_corpus(small=False): {len(corpus)} members in "
        f"{time.perf_counter() - t0:.1f}s")
    cfg = LanczosConfig(s=6, orth=Orth.FULL, n_wanted=10, tol=1e-8, max_restarts=100)
    bad, band = [], []
    for name, (A, exact) in corpus.items():
        r = np.random.default_rng(0).random(A.shape[0])
        # the kernels at this member's shape, before (not in) its counted solve
        note = check_dia_operator(torch, A, r, cfg.s) if isinstance(A, DiaMatrix) else ""
        res, delta, wall = counted(torch, totals, lambda: solve_auto(A, r, 60, cfg))
        got = np.sort(np.asarray(res.eigs, np.float64))[::-1][:10]
        scale = float(np.max(np.abs(np.sort(exact)[::-1][:10])))
        err = (max(float(np.min(np.abs(exact - g))) for g in got) / scale if len(got) == 10
               else float("inf"))
        log(f"I(b) {name:20s} {type(A).__name__:9s} n={A.shape[0]:5d} {res.solver:40s} "
            f"restarts={res.n_restarts:3d} err={err:.2e} (bound 1e-6) {wall:.2f}s "
            f"launches {_k12(delta)} {note}")
        if not (res.converged and err <= 1e-6):
            bad.append((name, res.converged, err))
        if delta["dia_powers_band"]:
            band.append(name)
    if bad:
        raise AssertionError(f"I(b) corpus members failed: {bad}")
    log(f"I(b) members whose solve launched K1's wide-band kernel: {band}")
    if not band:
        raise AssertionError("I(b): no corpus solve launched K1's wide-band kernel")
    del corpus

    # (c) the profiling tools on bench.py's operator
    data, offsets, _, _ = bench_operator()
    A = DiaMatrix(data=torch.as_tensor(data, device="cuda"), offsets=offsets)
    nd, n = data.shape
    rate, delta, _ = counted(torch, totals, lambda: profiling.measure_powers_throughput(A, s=8))
    rep = profiling.roofline_audit(A, rate)
    by = {row["name"]: row for row in rows}
    log(f"I(c) measure_powers_throughput (K2 chain, s=8): {rate / 1e9:.1f} Gnnz/s = "
        f"{n * nd / rate * 1e3:.4f} ms a step (phase 1's K2: "
        f"{by['dia_power_step']['ms']:.4f} ms), launches {_k12(delta)}; roofline_audit: "
        f"{rep.bytes_per_step} B/step, speed of light {rep.sol_nnz_per_s / 1e9:.1f} Gnnz/s, "
        f"fraction_of_peak {rep.fraction_of_peak:.3f} (bound 1.05)")
    if not (delta["dia_power_step"] > 0 and rep.fraction_of_peak <= 1.05):
        raise AssertionError(f"I(c) K2 chain: {rep.fraction_of_peak}, {delta}")
    for kernel, kname in (("roll", "dia_powers_fused"), ("ilv", "dia_powers_ilv"),
                          ("ilv_rm", "dia_powers_ilv")):
        it, delta, _ = counted(torch, totals, lambda: profiling.measure_ca_iteration_throughput(
            A, s=8, kernel=kernel))
        log(f"I(c) measure_ca_iteration_throughput({kernel!r}, s=8): {it:.1f} CA iterations/s "
            f"= {1e3 / it:.4f} ms an iteration (phase 1's {kname}: {by[kname]['ms']:.4f} ms "
            f"a call), launches {({k: v for k, v in delta.items() if v})}")
        if not it > 0 or not delta[kname] > 0:
            raise AssertionError(f"I(c) {kernel}: {it} {delta}")
    del A
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ca_lanczos_tpu_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    log(f"I(c) python -m ca_lanczos_tpu_torch.bench: rc={proc.returncode} in "
        f"{time.perf_counter() - t0:.1f}s: {' | '.join(lines)}")
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    keys = {"metric", "value", "unit", "vs_baseline", "spread_min", "spread_max", "trials",
            "path"}
    if set(line) != keys or not line["value"] > 0 or line["path"] != "cuda-dia-fused":
        raise AssertionError(f"I(c) bench line: {line} {proc.stderr[-2000:]}")
    # K1 reads the planes once per s steps: hold its figure against phase
    # 1's K1 bound for the same bytes, not the per-step roofline model
    nnz = sum(n - abs(o) for o in offsets)
    k1_ms = nnz * 8 / (line["value"] * 1e9) * 1e3
    k1 = by["dia_powers_fused"]
    log(f"I(c) bench K1: {line['value']} Gnnz/s = {k1_ms:.4f} ms a call (phase 1: "
        f"{k1['ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms; {k1['bound_ms'] / k1_ms:.0%} of it)")
    check_bound("dia_powers_fused (bench)", "float32", k1_ms, k1["bound_ms"])


def phase_j(torch, totals: dict, paths: dict, rows: list, n: int = 11010048) -> None:
    """The distributed layer on the card (module docstring, phase J);
    ``rows`` are phase 1's f32 kernel rows."""
    import tempfile

    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.parallel.runtime import spawn
    from ca_lanczos_tpu_torch.parallel.smoke import phase_j_rank
    from ca_lanczos_tpu_torch.utils import mmio

    P = min(4, torch.cuda.device_count())
    torch.cuda.empty_cache()
    d_a, off_a = flagship_planes(n)
    exact_a = np.load(os.path.join(ROOT, "exp", f"flagship_10m_oracle_{n}.npz"))["exact"]
    d_c, off_c, exact_c = cluster_planes(n)
    jobs = [
        ("J(a) dist_solve_auto, ilv/K3", dict(d=d_a, off=off_a, dtype="float32", max_lanczos=32,
                                              engine="auto"), exact_a, "ilv",
         "dist_restarted_ca_lanczos+polish10", "dia_powers_ilv", "A (fused)"),
        ("J(b) dist_restarted_ca_lanczos, natural/K1", dict(d=d_a, off=off_a, dtype="float32",
                                                            max_lanczos=32, engine="dia"),
         exact_a, "ilv", "dist_restarted_ca_lanczos+polish10", "dia_powers_fused", "E (host)"),
        ("J(c) dist_solve_auto, IRL first rung, f64 natural/K1",
         dict(d=d_c, off=off_c, dtype="float64", max_lanczos=48, engine="auto"), exact_c,
         "dia", "dist_impl_restarted_ca_lanczos+polish10", "dia_powers_fused", "F (IRL, f64)"),
    ]
    t0 = time.perf_counter()
    outs = spawn(phase_j_rank, P, "cuda", [j[1] for j in jobs], BOUND, timeout=900)
    log(f"J: {P} rank(s), NCCL; the three solves in {time.perf_counter() - t0:.1f}s "
        "(spawn, builds and kernel checks included)")
    failed = []
    by = {row["name"]: row for row in rows}
    for i, (label, _, exact, fmt, solver, kname, beside) in enumerate(jobs):
        res = outs[0][i]
        for rank, o in enumerate(outs):
            for key, v in o[i]["launches"].items():
                totals[key] = totals.get(key, 0) + v
            for k in o[i]["kernels"]:
                bms, bby = bound_ms(k["nbytes"], k["flops"], k["dtype"])
                lib = ("not measured" if k["library_ms"] is None
                       else f"{k['library_ms']:.4f} ms")
                log(f"{label} rank {rank}: kernel {k['name']} [{k['dtype']}] at the shard's "
                    f"shape {tuple(k['shape'])} s={k['s']}: rel_err={k['rel_err']:.3e} "
                    f"(bound {BOUND[k['dtype']]:.0e}) abs_err={k['max_abs_err']:.3e} kernel "
                    f"{k['ms']:.4f} ms plain {k['plain_ms']:.4f} ms bound {bms:.4f} ms "
                    f"({bby}; {bms / k['ms']:.0%} of it) library (one CSR matvec of the "
                    f"shard) {lib} [phase 1 f32 at bench.py's operator: "
                    f"{by[k['name']]['ms']:.4f} ms, bound {by[k['name']]['bound_ms']:.4f} ms]")
                if not k["ok"]:
                    failed.append(f"{label} rank {rank}: {k['name']} s={k['s']} disagrees "
                                  f"({k['rel_err']:.3e})")
                if o[i]["launches"].get(k["name"], 0) == 0:
                    failed.append(f"{label} rank {rank}: {k['name']} not launched by the solve")
                check_bound(f"{k['name']} s={k['s']} ({label})", k["dtype"], k["ms"], bms)
            log(f"{label} rank {rank}: n_local={o[i]['n_local']} halo={o[i]['halo']} "
                f"ilv_m_pad={o[i]['ilv_m_pad']}; launches {o[i]['launches']}; "
                f"peak {o[i]['peak_gib']:.2f} GiB")
            c = o[i]["comm"]
            log(f"{label} rank {rank}: one CA block: exchanges={c['exchanges']} "
                f"halo_elems={c['halo_elems']} all_reduce={c['all_reduce']} "
                f"({c['all_reduce_elems']} elems) all_gather={c['all_gather']} "
                f"({c['all_gather_elems']} elems); cross_device_consistency(R)={c['R_spread']}")
            if c["R_spread"] != 0.0:
                failed.append(f"{label} rank {rank}: replicated R differs across ranks")
        got = np.sort(np.asarray(res["eigs"]))[::-1]
        err = (float(np.max(np.abs(got - exact))) / abs(float(exact[0])) if len(got) == 10
               else float("inf"))
        presid = float(np.max(res["polish_resid"])) / abs(float(exact[0]))
        log(f"{label}: route={res['format']} engine={res['engine']} solver={res['label']} "
            f"converged={res['converged']} escalated={res['escalated']} "
            f"n_restarts={res['restarts']} eig_rel_err={err:.3e} (bound 1e-6) "
            f"max_polish_resid/|A|={presid:.3e}; notes {res['notes']}")
        log(f"{label}: stages " + " ".join(f"{k}={v:.2f}s" for k, v in res["stages"].items())
            + f" total={res['wall']:.2f}s (matrix + route {res['build_s']:.2f}s before it)")
        p = paths[beside]
        log(f"{label} beside path {beside}: restarts={p['restarts']} "
            + " ".join(f"{k}={v:.2f}s" for k, v in p["stages"].items())
            + f" total={p['total']:.2f}s")
        checks = {
            f"route == {fmt!r}": res["format"] == fmt,
            f"solver == {solver!r}": res["label"] == solver,
            "not escalated": not res["escalated"],
            "converged": res["converged"],
            "eig_rel_err <= 1e-6": err <= 1e-6,
            f"{kname} launched": res["launches"].get(kname, 0) > 0,
            "same eigs on every rank": all(np.array_equal(o[i]["eigs"], res["eigs"])
                                          for o in outs),
        }
        failed += [f"{label}: {k}" for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase J failed: {failed}")

    # (d) the CLI: scaling at [P] with the flagship's shard a rank, and
    # solve --mesh P on a 500-row file
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ca_lanczos_tpu_torch", "scaling",
                           "--devices", str(P), "--rows-per-device", str(n)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    log(f"J(d) python -m ca_lanczos_tpu_torch scaling --devices {P} --rows-per-device {n}: "
        f"rc={proc.returncode} in {time.perf_counter() - t0:.1f}s: {' | '.join(lines)}")
    if proc.returncode != 0 or len(lines) != 1 or json.loads(lines[0])["devices"] != P:
        raise AssertionError(f"J(d) scaling failed: {proc.stderr[-2000:]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "band500.mtx")
        dd = np.linspace(1.0, 40.0, 500)
        band = sp.diags([0.05 * np.ones(499), dd, 0.05 * np.ones(499)], [-1, 0, 1])
        mmio.save_mtx(path, band, symmetric=True)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ca_lanczos_tpu_torch", "solve", "--mtx",
                               path, "--n-wanted", "3", "--max-lanczos", "24", "--s", "4",
                               "--mesh", str(P)], cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    log(f"J(d) python -m ca_lanczos_tpu_torch solve --mesh {P} --mtx band500.mtx: "
        f"rc={proc.returncode} in {time.perf_counter() - t0:.1f}s: {' | '.join(lines)}")
    rec = json.loads(lines[0]) if proc.returncode == 0 and len(lines) == 1 else {}
    exact = np.sort(np.linalg.eigvalsh(band.toarray()))[::-1][:3]
    if not (rec.get("converged") and rec["solver"].startswith("dist_")
            and np.allclose(rec["eigs"][:3], exact, rtol=1e-7, atol=0)):
        raise AssertionError(f"J(d) solve --mesh failed: {rec} {proc.stderr[-2000:]}")


def _k_kernels(label: str, rank: int, rows: list, launches: dict, failed: list) -> None:
    """Log phase K's kernel rows of one rank (checked against the plain
    version on the rank's operands, each timed beside its bound and the
    library product) and record what failed: a disagreement, a kernel the
    solve did not launch, a time under the bound."""
    for k in rows:
        bms, bby = bound_ms(k["nbytes"], k["flops"], k["dtype"])
        lib = "not measured" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        log(f"{label} rank {rank}: kernel {k['name']} [{k['dtype']}] at {tuple(k['shape'])} "
            f"s={k['s']}: rel_err={k['rel_err']:.3e} (bound {BOUND[k['dtype']]:.0e}) "
            f"abs_err={k['max_abs_err']:.3e} kernel {k['ms']:.4f} ms plain {k['plain_ms']:.4f} "
            f"ms bound {bms:.4f} ms ({bby}; {bms / k['ms']:.0%} of it) library (one CSR "
            f"matvec of the shard) {lib}")
        if not k["ok"]:
            failed.append(f"{label} rank {rank}: {k['name']} s={k['s']} disagrees "
                          f"({k['rel_err']:.3e})")
        if launches.get(k["name"], 0) == 0:
            failed.append(f"{label} rank {rank}: {k['name']} not launched")
        check_bound(f"{k['name']} s={k['s']} ({label})", k["dtype"], k["ms"], bms)


def phase_k(torch, totals: dict, a32, pell_exact, nb: int = BSR_NB, n_osc: int = PROP_N):
    """The distributed layer's second slice on the card (module docstring,
    phase K): one spawn of ``parallel.smoke.phase_k_rank``."""
    import tempfile

    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.parallel.runtime import spawn
    from ca_lanczos_tpu_torch.parallel.smoke import phase_k_rank

    P = min(4, torch.cuda.device_count())
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        inputs = {"pell": os.path.join(tmp, "pell.npz"), "bsr": os.path.join(tmp, "bsr.npz"),
                  "osc_n": n_osc}
        sp.save_npz(inputs["pell"], a32, compressed=False)
        vals, cols, top = planted_block_tridiag(nb)
        np.savez(inputs["bsr"], vals=vals, cols=cols, top=top)
        del vals, cols
        log(f"K: inputs written in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        outs = spawn(phase_k_rank, P, "cuda", inputs, BOUND, timeout=900)
    log(f"K: {P} rank(s), NCCL; K(a)-K(d) in {time.perf_counter() - t0:.1f}s "
        "(spawn and kernel checks included)")
    failed = []
    norm_a = abs(float(pell_exact[0]))
    for rank, o in enumerate(outs):
        for part, launches in (("a", o["a"]["launches"]), ("b", o["b"]["launches"]),
                               ("c", o["c"]["launches"]), ("c", o["c"]["sstep_launches"]),
                               ("d", o["d"]["launches"])):
            for key, v in launches.items():
                totals[key] = totals.get(key, 0) + v
        _k_kernels("K(a)", rank, o["a"]["kernels"], o["a"]["launches"], failed)
        _k_kernels("K(b)", rank, o["b"]["kernels"], o["b"]["launches"], failed)
        _k_kernels("K(c) sstep", rank, o["c"]["kernels"], o["c"]["sstep_launches"], failed)
        _k_kernels("K(d)", rank, o["d"]["kernels"], o["d"]["launches"], failed)
    a, b, c, d = (outs[0][k] for k in "abcd")

    # K(a): general sparsity end to end through dist_solve_auto
    got = np.sort(np.asarray(a["eigs"]))[::-1]
    err = (float(np.max(np.abs(got - pell_exact))) / norm_a if len(got) == 10
           else float("inf"))
    log(f"K(a) dist_solve_auto (max_diags=16): n={a['n']} nnz={a['nnz']} route={a['format']} "
        f"solver={a['label']} converged={a['converged']} escalated={a['escalated']} "
        f"n_restarts={a['restarts']} eig_rel_err={err:.3e} (bound 1e-6) "
        f"max_polish_resid/|A|={float(np.max(a['polish_resid'])) / norm_a:.3e}; "
        f"notes {a['route_notes']}")
    log(f"K(a) window: m={a['m']} = n_local {a['n_local']} + 2 x halo {a['halo']}, unit K="
        f"{a['K']} sw={a['sw']} n_win={a['n_win']}; route_dist_operator (ELL + the whole "
        f"matrix's PELL encode) {a['route_s']:.2f}s, window partition {a['partition_s']:.2f}s, "
        f"window encode {a['encode_s']:.2f}s")
    log("K(a) stages " + " ".join(f"{k}={v:.2f}s" for k, v in a["stages"].items())
        + f" total={a['wall']:.2f}s; launches {a['launches']}; peak {a['peak_gib']:.2f} GiB")
    cm = a["comm"]
    log(f"K(a) one CA block: exchanges={cm['exchanges']} halo_elems={cm['halo_elems']} "
        f"all_reduce={cm['all_reduce']} ({cm['all_reduce_elems']} elems) all_gather="
        f"{cm['all_gather']} ({cm['all_gather_elems']} elems); "
        f"cross_device_consistency(R)={cm['R_spread']}")
    checks = {
        "K(a) route == 'pell'": a["format"] == "pell",
        "K(a) solver == 'dist_restarted_ca_lanczos+polish10'":
            a["label"] == "dist_restarted_ca_lanczos+polish10",
        "K(a) not escalated": not a["escalated"],
        "K(a) converged": a["converged"],
        "K(a) eig_rel_err <= 1e-6": err <= 1e-6,
        "K(a) pell_step_unit launched": a["launches"].get("pell_step_unit", 0) > 0,
        "K(a) same eigs on every rank": all(np.array_equal(o["a"]["eigs"], a["eigs"])
                                           for o in outs),
        "K(a) R spread 0": all(o["a"]["comm"]["R_spread"] == 0.0 for o in outs),
    }

    # K(b): DistEll against DistPell, dist_ca_lanczos s = 4, 24 steps
    gap = float(np.max(np.abs(b["ritz_ell"][:10] - b["ritz_pell"][:10]))) / norm_a
    log(f"K(b) dist_ca_lanczos (s=4, 24 steps, monomial) on {b['ops'][0]} and {b['ops'][1]} "
        f"(window m={b['m']}, halo {b['halo']}, from_ell {b['from_ell_s']:.2f}s): top-10 Ritz "
        f"max gap / |A| = {gap:.3e} (bound 1e-5); both {b['wall']:.2f}s; launches "
        f"{b['launches']}; top Ritz {np.round(b['ritz_pell'][:3], 6).tolist()}")
    checks.update({
        "K(b) operators DistEll, DistPell": tuple(b["ops"]) == ("DistEll", "DistPell"),
        "K(b) Ritz parity <= 1e-5": gap <= 1e-5,
    })

    # K(c): BASELINE.json configs[4] through the distributed drivers
    want = np.sort(c["top"].astype(np.float64))[::-1][:3]
    got = np.sort(np.asarray(c["eigs"], np.float64))[::-1][:3]
    err_c = float(np.max(np.abs(got - want)) / want[0]) if len(got) == 3 else float("inf")
    dT = float(np.max(np.abs(c["sstep_T"] - c["sstep_T_single"]))
               / np.max(np.abs(c["sstep_T_single"])))
    log(f"K(c) DistBsr n={c['n']} tiles {tuple(c['tiles'])}: halo_b={c['halo_b']} n_local="
        f"{c['n_local']} from_bsr {c['partition_s']:.2f}s; dist_bsr_matrix_powers (s=4) "
        f"{c['dist_powers_ms']:.4f} ms vs the single card's BsrMatrix powers "
        f"{c['single_powers_ms']:.4f} ms (CUDA events), max column gap {c['powers_gap']:.3e}")
    log(f"K(c) dist_restarted_ca_lanczos(A, x, 16, s=4, n_wanted=3, tol=1e-4): converged="
        f"{c['converged']} restarts={c['restarts']} top3_rel_err={err_c:.3e} (bound 1e-6) "
        f"solve {c['wall']:.2f}s peak {c['peak_gib']:.2f} GiB launches {c['launches']}")
    log(f"K(c) dist_sstep_lanczos (s=4, m=3, f64 DIA, {c['nd']} diagonals) vs the single "
        f"card's sstep_lanczos: max|dT|/max|T| = {dT:.3e} (bound 1e-10); dist "
        f"{c['sstep_wall']:.2f}s, single {c['sstep_single_s']:.2f}s; launches "
        f"{c['sstep_launches']}")
    checks.update({
        "K(c) converged": c["converged"],
        "K(c) top3_rel_err <= 1e-6": err_c <= 1e-6,
        "K(c) dist powers == single card's (1e-5)": c["powers_gap"] <= BOUND["float32"],
        "K(c) sstep T <= 1e-10": dT <= 1e-10,
        "K(c) sstep launched K1's wide-band kernel": c["sstep_launches"].get(
            "dia_powers_band", 0) > 0,
    })

    # K(d): distributed propagation at G(b)'s physics
    log(f"K(d) dist_propagate_split on the {d['n']}-row oscillator (5-offset circulant "
        f"DistDia, periodic, n_local={d['n_local']} halo={d['halo']}): {d['steps']} steps, "
        f"Krylov {d['krylov']}, dt={d['dt']:.6e}: {d['wall'] / d['steps'] * 1e3:.2f} ms per "
        f"time step (single card's propagate_split {d['single_s'] / d['steps'] * 1e3:.2f} ms); "
        f"max|dpsi|/max|psi| = {d['diff']:.3e} (bound 1e-8), drift {d['drift']:.3e} "
        f"(bound 1e-10; single card {d['single_drift']:.3e}), moved {d['moved']:.3e}; "
        f"launches {d['launches']}")
    checks.update({
        "K(d) vs propagate_split <= 1e-8": d["diff"] <= 1e-8,
        "K(d) drift <= 1e-10": abs(d["drift"]) <= 1e-10,
    })
    failed += [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase K failed: {failed}")


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
    rows += phase1_bsr(torch)
    rows += phase1_trsm(torch)
    log(f"phase 1 (kernels vs plain): {time.perf_counter() - t0:.1f}s")
    phase(torch, "phase S (host SpMM vs scipy)", lambda: phase_s(torch, a32))

    totals: dict = {}
    fa, exact = flagship(11010048)
    fa32 = fa.astype(np.float32)
    del fa
    path_a = phase(torch, "phase 2", lambda: main_path(
        torch, "phase 2 (main path A, DIA/K1)", fa32, exact, "dia", ["dia_powers_fused"],
        totals, engine="fused", prefer="dia"))
    fb, exact_b = flagship(4194304)
    # the interleaved route's permutation sends B's polish to the host SpMM
    path_b = phase(torch, "phase 3", lambda: main_path(
        torch, "phase 3 (main path B, ilv/K3)", fb.astype(np.float32), exact_b, "ilv",
        ["dia_powers_ilv", "csr_spmm_host"], totals, engine="fused", prefer="auto"))
    del fb
    # phase 1 showed that encoding="auto" picks grouped on this matrix
    path_c = phase(torch, "phase C", lambda: main_path(
        torch, "phase C (main path C, PELL grouped/K5)", a32, pell_exact, "pell",
        ["pell_step_grouped"], totals, engine="fused", prefer="pell", encoding="auto"))
    path_d = phase(torch, "phase D", lambda: main_path(
        torch, "phase D (main path D, PELL unit/K4)", a32, pell_exact, "pell",
        ["pell_step_unit"], totals, engine="fused", prefer="pell", encoding="unit"))
    for label, p in (("B", path_b), ("C", path_c), ("D", path_d)):
        log(f"polish seconds: {label}: polish={p['stages']['polish']:.2f}s of "
            f"total={p['total']:.2f}s; host SpMM applies {p['applies']}")
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
    phase(torch, "phase I", lambda: phase_i(torch, totals, rows))
    phase(torch, "phase J", lambda: phase_j(
        torch, totals, {"A (fused)": path_a, "E (host)": path_e, "F (IRL, f64)": path_f}, rows))
    phase(torch, "phase K", lambda: phase_k(torch, totals, a32, pell_exact))
    del a32

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
