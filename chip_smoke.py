#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's banded main path once on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phase 0  the card (nvidia-smi name and power limit), TF32 off, build of the
         CUDA kernels from ``ca_lanczos_tpu_torch/csrc`` into build/kernels.
Phase 1  each kernel against its plain PyTorch version on the card, at the
         main path's shapes (bench.py's operator: 4,194,304 rows x 9
         diagonals, s=8, Newton coefficients from the port's own bootstrap),
         f32 and f64: max error relative to max|plain| per step (bounds 1e-5
         f32, 1e-12 f64; the sums run in another order), median CUDA-event
         times over 20 reps after warm-up, Gnnz/s = nnz*s/t.
Phase 2  main path A: ``solve_auto`` on the 11,010,048-row f32 flagship
         tridiagonal (exp/flagship_10m.py's matrix), prefer="dia" -> K1,
         polish=10, over_lock=3; checked against the committed oracle.
Phase 3  main path B: the same at 4,194,304 rows with prefer="auto" -> the
         interleaved route -> K3.

Every launch counter is set to 0 just before phase 2 and read just after
phase 3.  Any failed check raises (exit code != 0).  The line before the
last is {"kernels": [...]}; the last is {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REPS = 20
BOUND = {"float32": 1e-5, "float64": 1e-12}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = REPS, warm: int = 3) -> float:
    """Median milliseconds of fn() over reps, CUDA events around each call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def rel_err(torch, got, ref) -> float:
    """max over rows of max|got - ref| / max|ref| (rows = steps)."""
    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    num = (got - ref).abs().amax(dim=1)
    den = ref.abs().amax(dim=1)
    return float((num / den).max())


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
    from ca_lanczos_tpu_torch.ops import _cuda_build, cuda_ilv, cuda_spmv

    for name, load in (("dia_powers", cuda_spmv._lib), ("ilv_powers", cuda_ilv._lib)):
        t0 = time.perf_counter()
        load()
        log(f"build {name}: {time.perf_counter() - t0:.1f}s "
            f"-> {_cuda_build.library_path(name).name}")
        for line in _cuda_build.build_log(name).splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                log(f"  {line.strip()}")
    return smi


def phase1(torch):
    """Kernels vs plain versions; returns the f32 rows for the JSON line."""
    from ca_lanczos_tpu_torch.config import Basis
    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_spmv
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
    from ca_lanczos_tpu_torch.solvers.ca_lanczos import build_basis_matrix

    n, s = 1 << 22, 8
    offsets = tuple(range(-4, 5))
    nd = len(offsets)
    rng = np.random.default_rng(0)  # bench.py:123-134
    data = np.asarray(rng.standard_normal((nd, n)), np.float32) * 0.02
    data[nd // 2] += 0.8
    x = np.asarray(rng.standard_normal(n), np.float32)
    x /= np.linalg.norm(x)
    vprev = np.asarray(rng.standard_normal(n), np.float32)
    nnz = sum(n - abs(o) for o in offsets)
    # Newton coefficients as the main path makes them (2s-step bootstrap).
    A64 = DiaMatrix(data=torch.as_tensor(data, dtype=torch.float64, device="cuda"),
                    offsets=offsets)
    Bk = build_basis_matrix(A64, torch.as_tensor(x, dtype=torch.float64, device="cuda"),
                            s, Basis.NEWTON)
    coefs = np.zeros((s, 2))
    coefs[:, 0] = np.diagonal(Bk)[:s]
    coefs[1:, 1] = np.diagonal(Bk, 1)[: s - 1]
    log(f"newton coefs: shifts {np.round(coefs[:, 0], 4).tolist()} "
        f"subs {np.round(coefs[:, 1], 6).tolist()}")
    del A64

    rows = []
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        D = torch.as_tensor(data, dtype=dt, device="cuda")
        X = torch.as_tensor(x, dtype=dt, device="cuda")
        P = torch.as_tensor(vprev, dtype=dt, device="cuda")
        D_il = cuda_ilv.IlvDiaMatrix.from_dia(DiaMatrix(data=D, offsets=offsets),
                                              keep_dia=False).data_il
        X_il = cuda_ilv.ilv_encode(X).contiguous()
        cases = [
            ("dia_powers_fused", "ca_lanczos_tpu_torch/csrc/dia_powers.cu",
             "ca_lanczos_tpu/ops/pallas_spmv.py:403", s,
             lambda: cuda_spmv.dia_powers_fused(D, X, coefs, offsets, s),
             lambda: cuda_spmv.dia_powers_fused_ref(D, X, coefs, offsets, s)),
            ("dia_power_step", "ca_lanczos_tpu_torch/csrc/dia_powers.cu",
             "ca_lanczos_tpu/ops/pallas_spmv.py:113", 1,
             lambda: cuda_spmv.dia_power_step(D, X, P, coefs[1], offsets),
             lambda: cuda_spmv.dia_power_step_ref(D, X, P, coefs[1], offsets)),
            ("dia_powers_ilv", "ca_lanczos_tpu_torch/csrc/ilv_powers.cu",
             "ca_lanczos_tpu/ops/pallas_ilv.py:301", s,
             lambda: cuda_ilv.dia_powers_ilv(D_il, X_il, coefs, offsets, s),
             lambda: cuda_ilv.dia_powers_ilv_ref(D_il, X_il, coefs, offsets, s)),
        ]
        for kname, src, replaces, steps, kern, plain in cases:
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if isinstance(got, tuple):
                err = max(rel_err(torch, got[0], ref[0]), rel_err(torch, got[1], ref[1]))
                abs_err = max(float((got[0] - ref[0]).abs().max()),
                              float((got[1] - ref[1]).abs().max()))
                finite = bool(torch.isfinite(got[0]).all())
            else:
                err = rel_err(torch, got, ref)
                abs_err = float((got - ref).abs().max())
                finite = bool(torch.isfinite(got).all())
            del got, ref
            ms = time_ms(torch, kern)
            plain_ms = time_ms(torch, plain)
            gnnz = nnz * steps / (ms * 1e-3) / 1e9
            log(f"kernel {kname} [{name}] n={n} nd={nd} s={steps}: rel_err={err:.3e} "
                f"(bound {BOUND[name]:.0e}) abs_err={abs_err:.3e} "
                f"kernel {ms:.4f} ms ({gnnz:.1f} Gnnz/s) plain {plain_ms:.4f} ms "
                f"({nnz * steps / (plain_ms * 1e-3) / 1e9:.1f} Gnnz/s) "
                f"speedup {plain_ms / ms:.2f}x")
            if not finite or not err <= BOUND[name]:
                raise AssertionError(f"{kname} [{name}] disagrees with its plain version")
            if dt == torch.float32:
                rows.append(dict(name=kname, route="cuda", source=src, replaces=replaces,
                                 max_abs_err=abs_err, ms=ms, plain_ms=plain_ms))
        del D, X, P, D_il, X_il
    torch.cuda.empty_cache()
    return rows


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


def main_path(torch, label: str, n: int, prefer: str, fmt: str, launches_key: str):
    from ca_lanczos_tpu_torch.config import LanczosConfig
    from ca_lanczos_tpu_torch.harness.auto import solve_auto
    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_spmv

    t0 = time.perf_counter()
    a, exact = flagship(n)
    a32 = a.astype(np.float32)
    del a
    log(f"{label}: n={n} matrix built in {time.perf_counter() - t0:.1f}s")
    before = {**cuda_spmv.LAUNCHES, **cuda_ilv.LAUNCHES}
    t0 = time.perf_counter()
    res = solve_auto(
        a32, np.ones(n), 32,
        LanczosConfig(n_wanted=10, s=8, tol=1e-4, max_restarts=200),
        engine="fused", polish=10, over_lock=3, prefer=prefer, device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = {**cuda_spmv.LAUNCHES, **cuda_ilv.LAUNCHES}
    delta = {k: after[k] - before[k] for k in after}
    got = np.sort(np.asarray(res.eigs))[::-1]
    err = float(np.max(np.abs(got - exact))) / 100.0 if len(got) == 10 else float("inf")
    Q = res.Q_conv
    log(f"{label}: route={res.route.format} solver={res.solver} converged={res.converged} "
        f"n_restarts={res.n_restarts} escalated={res.escalated}")
    log(f"{label}: stages " + " ".join(f"{k}={v:.2f}s" for k, v in res.stage_seconds.items())
        + f" total={wall:.2f}s")
    log(f"{label}: eig_rel_err={err:.3e} (bound 1e-6) "
        f"max_polish_resid/100={float(np.max(res.polish_resid)) / 100:.3e} "
        f"launches={delta}")
    log(f"{label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    checks = {
        f"route.format == {fmt!r}": res.route.format == fmt,
        "solver == 'restarted_ca_lanczos+polish10'":
            res.solver == "restarted_ca_lanczos+polish10",
        "converged": res.converged,
        f"{launches_key} launched": delta[launches_key] > 0,
        "eig_rel_err <= 1e-6": err <= 1e-6,
        "Q_conv (n, 10) finite": tuple(Q.shape) == (n, 10) and bool(torch.isfinite(Q).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{label} failed: {failed}")
    del res, Q
    torch.cuda.empty_cache()


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
    log(f"phase 0 (card, build): {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    rows = phase1(torch)
    log(f"phase 1 (kernels vs plain): {time.perf_counter() - t0:.1f}s")

    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_spmv

    for counts in (cuda_spmv.LAUNCHES, cuda_ilv.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    main_path(torch, "phase 2 (main path A, DIA/K1)", 11010048, "dia", "dia",
              "dia_powers_fused")
    log(f"phase 2: {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    main_path(torch, "phase 3 (main path B, ilv/K3)", 4194304, "auto", "ilv",
              "dia_powers_ilv")
    log(f"phase 3: {time.perf_counter() - t0:.1f}s")
    launches = {**cuda_spmv.LAUNCHES, **cuda_ilv.LAUNCHES}
    for row in rows:
        row["launches"] = launches[row["name"]]
    idle = [row["name"] for row in rows if row["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels of the path not launched by the main path: {idle}")
    log(f"total: {time.perf_counter() - t00:.1f}s")
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                             "max_abs_err", "ms", "plain_ms")} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
