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

Phases 2 and 3, C and D use engine="fused"; paths A-D check the label
"restarted_ca_lanczos+polish10", E the same at the host engine, F
"impl_restarted_ca_lanczos+polish10"; none may escalate.  Every launch
counter is set to 0 just before each main path and read just after it; a
kernel's ``launches`` is the sum over the main paths.  Any failed check
raises (exit code != 0).  The line before the last is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.  Without a
CUDA device, or outside a checkout, it exits non-zero and prints no result.
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


def dia_row(torch, kname, name, n, nd, nnz, steps, nbytes, flops, kern, plain):
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
    plain_ms = time_ms(torch, plain)
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
    for counts in counters():
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solve_auto(
        a, np.ones(n), max_lanczos,
        LanczosConfig(n_wanted=10, s=8, tol=1e-4, max_restarts=200),
        polish=10, over_lock=3, device="cuda", **kw,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    delta = {k: v for counts in counters() for k, v in counts.items()}
    for k, v in delta.items():
        totals[k] = totals.get(k, 0) + v
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
