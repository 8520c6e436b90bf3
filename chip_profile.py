#!/usr/bin/env python3
"""Profile the stages of the PyTorch/CUDA port's main paths on one GPU.

Run from the root of a checkout:
``python3 chip_profile.py [--root DIR] [A] [B] [C] [D] [E] [F] [G] [H]`` (no
letter: all eight).  ``--root DIR`` profiles the package of another tree unpacked at DIR
(for instance the parent commit, as for chip_compare.py), so that two
versions are measured in one call.

It takes chip_smoke.py's configurations (A: the 11,010,048-row f32 flagship
tridiagonal with prefer="dia", solved through K1; B: 4,194,304 rows with
prefer="auto", solved on the interleaved route through K3; C: the
11,010,048-row PELL oracle matrix with prefer="pell", encoding="auto",
solved through K5; D: the same with encoding="unit", solved through K4;
E: A's matrix solved by the host driver ``restarted_ca_lanczos``, the
default engine; F: chip_smoke.py's clustered float64 matrix solved by the
IRL ``impl_restarted_ca_lanczos`` at max_lanczos=48), runs each stage of
``solve_auto`` on its own and prints, per configuration:

* route seconds (``make_operator``) and probe seconds (``recommend_solver``);
* the solve's wall seconds unprofiled, twice (the first run pays the
  first use of cuBLAS/cuSOLVER), restarts and locked pairs (the fused
  driver for A-D, the host drivers for E and F);
* the same solve under ``torch.profiler``: device busy seconds (the union
  of the device's kernel and copy intervals), the idle share
  ``1 - busy / unprofiled wall`` (the profiler slows the host, so its own
  wall is not used), the device ms per call of each hand-written kernel,
  and the top 15 operators and kernels by device time;
* the polish: for A, C and D the host preparation of the f64 planes (offset
  scan, scipy DIA conversion) and the device polish, profiled like the
  solve; for B (a permuted route) the host polish's wall seconds.

G and H are chip_smoke.py's phases of the same names: G the time
propagators (20 time steps of ``propagate`` lanczos and
``propagate_split_fused`` on the 512-row ELL oscillator; 5 time steps of
``propagate`` lanczos and ca-newton and of ``propagate_split_fused`` on
the 4,194,304-row f64 DIA oscillator), H ``restarted_ca_lanczos`` on the
10,485,760-row BSR and on its DIA form; each solve is timed twice
unprofiled and once profiled as above.

Host-clock seconds end with the device synchronised.  Without a CUDA
device it exits non-zero.
"""

import os
import sys
import time

import numpy as np

import chip_smoke

DEVICE = "cuda"
ROWS = 15  # rows of each profiler table
# K1's kernels (dia_powers_fused_kernel: K1 of trees before its register
# kernel, for --root), K2, K3, K4, K5
KERNELS = ("dia_powers_reg", "dia_powers_smem", "dia_powers_fused_kernel",
           "dia_power_step_kernel", "ilv_powers", "pell_unit_kernel", "pell_grouped_kernel")


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profiled(torch, label: str, fn, wall: float):
    """Run fn under torch.profiler; print busy time, idle share against the
    unprofiled ``wall``, per-call kernel times and the top rows by device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, pwall = timed(torch, fn)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b in spans:  # union of device intervals, microseconds
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if not spans:
        print(f"{label} profiled: wall {pwall:.3f}s; the profiler recorded no device "
              "events, device time not measured")
        return
    busy *= 1e-6
    print(f"{label} profiled: wall {pwall:.3f}s device busy {busy:.3f}s idle share "
          f"{1.0 - busy / wall:.3f} (vs unprofiled wall {wall:.3f}s)")
    for avg in prof.key_averages():
        for k in KERNELS:
            if k in avg.key:
                t = avg.self_device_time_total
                print(f"{label} kernel {k} ({avg.key[:80]}): {avg.count} calls, "
                      f"{t / avg.count / 1e3:.4f} ms/call, {t / 1e6:.4f}s")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=ROWS,
                                    max_name_column_width=60))


def configuration(torch, label: str, a, prefer: str, driver: str = "fused",
                  max_lanczos: int = 32, **route_kw) -> None:
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.config import LanczosConfig
    from ca_lanczos_tpu_torch.harness import auto
    from ca_lanczos_tpu_torch.harness.matrix_info import recommend_solver
    from ca_lanczos_tpu_torch.ops.formats import make_operator
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
    from ca_lanczos_tpu_torch.solvers.fused_restarted import fused_restarted_ca_lanczos
    from ca_lanczos_tpu_torch.solvers.implicitly_restarted import impl_restarted_ca_lanczos
    from ca_lanczos_tpu_torch.solvers.restarted import restarted_ca_lanczos
    from ca_lanczos_tpu_torch.solvers.polish import rayleigh_ritz_polish

    n = a.shape[0]
    a_solve = a if driver == "irl" else a.astype(np.float32)  # F runs in float64
    cfg = LanczosConfig(n_wanted=13, s=8, tol=1e-4, max_restarts=200)  # 10 + over_lock 3
    (A, route), t = timed(torch, lambda: make_operator(a_solve, prefer=prefer, device=DEVICE,
                                                       **route_kw))
    print(f"== {label}: n={n} prefer={prefer} {route_kw} route={route.format} "
          f"{getattr(A, 'enc', '')} make_operator {t:.3f}s")
    r = torch.as_tensor(route.apply(np.ones(n)), dtype=A.dtype, device=A.device)
    rec, t = timed(torch, lambda: recommend_solver(A, n_wanted=cfg.n_wanted, probe_steps=40))
    print(f"{label} probe {t:.3f}s -> {rec['driver']}")

    def solve():
        if driver == "host":
            return restarted_ca_lanczos(A, r, max_lanczos, cfg)
        if driver == "irl":
            return impl_restarted_ca_lanczos(A, r, max_lanczos, n_wanted=cfg.n_wanted, s=cfg.s,
                                             basis=cfg.basis, orth=cfg.orth, tol=cfg.tol,
                                             max_restarts=cfg.max_restarts)
        return fused_restarted_ca_lanczos(A, r, max_lanczos, n_wanted=cfg.n_wanted, s=cfg.s,
                                          basis=cfg.basis, tol=cfg.tol,
                                          max_restarts=cfg.max_restarts)

    for rep in range(2):
        res, wall = timed(torch, solve)
        locked = int(np.sum(np.isfinite(np.asarray(res.eigs, np.float64))))
        print(f"{label} solve unprofiled rep{rep}: {wall:.3f}s "
              f"restarts={res.n_restarts} locked={locked} converged={res.converged}")
    profiled(torch, f"{label} solve", solve, wall)
    Q = route.restore(res.Q_conv)
    if route.perm is None:
        coo = sp.coo_matrix(a)
        _, t_off = timed(torch, lambda: np.unique(coo.col.astype(np.int64) - coo.row))
        d, t_dia = timed(torch, lambda: sp.dia_matrix(sp.csr_matrix(a).astype(np.float64)))
        planes, t_rows = timed(torch, lambda: auto._dia_rows(d))
        data, t_h2d = timed(torch, lambda: torch.as_tensor(planes, device=DEVICE))
        A64 = DiaMatrix(data=data, offsets=tuple(int(o) for o in d.offsets))
        print(f"{label} polish host prep: offsets {t_off:.3f}s dia planes {t_dia:.3f}s "
              f"row layout {t_rows:.3f}s to the card {t_h2d:.3f}s ({len(d.offsets)} diagonals)")
        polish = lambda: rayleigh_ritz_polish(A64, Q, iters=10, depth=4)  # noqa: E731
        polish()  # first use
        _, wall = timed(torch, polish)
        print(f"{label} device polish unprofiled: {wall:.3f}s")
        profiled(torch, f"{label} device polish", polish, wall)
    else:
        _, t = timed(torch, lambda: auto._polish_block(a, A, route, Q, "largest", 10, 4))
        print(f"{label} host polish: {t:.3f}s")
    torch.cuda.empty_cache()


def solves(torch, label: str, fn) -> None:
    """fn timed twice unprofiled, then profiled (the G and H rows)."""
    for rep in range(2):
        _, wall = timed(torch, fn)
        print(f"{label} unprofiled rep{rep}: {wall:.3f}s")
    profiled(torch, label, fn, wall)


def propagation(torch) -> None:
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.ops.formats import make_operator
    from ca_lanczos_tpu_torch.ops.spmv import normest
    from ca_lanczos_tpu_torch.solvers import propagators as P
    from ca_lanczos_tpu_torch.utils.matrices import gaussian_packet, harmonic_oscillator

    H, x = harmonic_oscillator(512, device=DEVICE)
    psi = torch.as_tensor(gaussian_packet(x), dtype=torch.complex128, device=DEVICE)
    solves(torch, "G(a) propagate lanczos x20",
           lambda: P.propagate(H, psi, 0.025, 20, 24, "lanczos"))
    solves(torch, "G(a) propagate_split_fused x20",
           lambda: P.propagate_split_fused(H, psi, 0.025, 20, 24))
    n = chip_smoke.PROP_N
    He, xb = harmonic_oscillator(n, device="cpu")
    rows = np.repeat(np.arange(n), He.vals.shape[1])
    Hb, _ = make_operator(sp.csr_matrix((He.vals.numpy().ravel(),
                                         (rows, He.cols.numpy().ravel())), (n, n)),
                          prefer="dia", device=DEVICE)
    dt = 0.025 * normest(H) / normest(Hb)
    psib = torch.as_tensor(gaussian_packet(xb), dtype=torch.complex128, device=DEVICE)
    for label, method in (("lanczos", "lanczos"), ("ca-newton", "ca")):
        solves(torch, f"G(b) propagate {label} x5",
               lambda: P.propagate(Hb, psib, dt, 5, 24, method, s=6))
    solves(torch, "G(b) propagate_split_fused x5",
           lambda: P.propagate_split_fused(Hb, psib, dt, 5, 24))
    torch.cuda.empty_cache()


def bsr_solves(torch) -> None:
    from ca_lanczos_tpu_torch.config import LanczosConfig
    from ca_lanczos_tpu_torch.solvers.restarted import restarted_ca_lanczos

    A, _ = chip_smoke.bsr_operator(torch)
    x = np.asarray(np.random.default_rng(1).standard_normal(A.n), np.float32)
    x = torch.as_tensor(x / np.linalg.norm(x), device=DEVICE)
    cfg = LanczosConfig(s=4, n_wanted=3, tol=1e-4, max_restarts=30)
    for label, Op in (("BSR", A), ("DIA", A.to_dia())):
        solves(torch, f"H {label} restarted_ca_lanczos",
               lambda: restarted_ca_lanczos(Op, x, 16, cfg))
    torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--root"]:
        root = os.path.abspath(args[1])
        sys.path.insert(0, root)  # before the package is first imported
        args = args[2:]
        print(f"package from {root}")
    import torch

    if not torch.cuda.is_available():
        print("chip_profile.py: no CUDA device visible; this script needs one GPU",
              file=sys.stderr)
        return 2
    chip_smoke.phase0(torch)
    which = set(args) or {"A", "B", "C", "D", "E", "F", "G", "H"}
    if "A" in which:
        configuration(torch, "A", chip_smoke.flagship(11010048)[0], "dia")
    if "B" in which:
        configuration(torch, "B", chip_smoke.flagship(4194304)[0], "auto")
    if "C" in which:
        configuration(torch, "C", chip_smoke.pell_operator(chip_smoke.PELL_N)[0], "pell",
                      encoding="auto")
    if "D" in which:
        configuration(torch, "D", chip_smoke.pell_operator(chip_smoke.PELL_N)[0], "pell",
                      encoding="unit")
    if "E" in which:
        configuration(torch, "E", chip_smoke.flagship(11010048)[0], "dia", driver="host")
    if "F" in which:
        configuration(torch, "F", chip_smoke.cluster(11010048)[0], "dia", driver="irl",
                      max_lanczos=48)
    if "G" in which:
        propagation(torch)
    if "H" in which:
        bsr_solves(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
