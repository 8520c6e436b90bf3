"""Command-line harness: ``python -m ca_lanczos_tpu_torch <command>``.

Counterpart of ``ca_lanczos_tpu/__main__.py``, with the same commands,
flags, defaults and JSON records:

  propagation  — runLanczos.m experiment (std vs CA propagators + oracle)
  sweep        — restarted CA-Lanczos (s, orth) sweep over a matrix set
  info         — corpus metadata (get_matrix_info.m analogue)
  solve        — one-call production eigensolve: .mtx in, eigenvalues out
                 (format routing + driver escalation, harness.solve_auto)

  scaling      — weak-scaling sweep of the distributed matrix powers

The JAX package's ``--platform`` and ``--x64`` become ``--device {cuda,
cpu}`` (default cuda; the port computes in the operator's dtype, float64
for .mtx input).  ``solve --mesh N`` starts N ranks on this host
(``parallel.runtime.spawn``: one card each, refused when fewer cards are
visible, or gloo CPU ranks with ``--device cpu``) and runs
``parallel.dist_solve_auto``; ``--hosts H`` makes the mesh H x N/H.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p):
    p.add_argument("--out", default=None, help="JSONL output path (default stdout)")


def _emit(records, out):
    lines = [r.to_json() if hasattr(r, "to_json") else json.dumps(r) for r in records]
    if out:
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {len(lines)} records to {out}")
    else:
        print("\n".join(lines))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ca_lanczos_tpu_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where operators and vectors live (cpu: the kernels' plain "
                    "PyTorch versions)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("propagation", help="harmonic-oscillator propagation experiment")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--dt", type=float, default=0.025)
    p.add_argument("--krylov", type=int, default=24)
    p.add_argument("--s", type=int, default=6)
    p.add_argument("--no-oracle", action="store_true")
    _add_common(p)

    p = sub.add_parser("sweep", help="restarted CA-Lanczos parameter sweep")
    p.add_argument("--mtx", nargs="*", default=[], help=".mtx files (default: synthetic diagonals)")
    p.add_argument("--s", type=int, nargs="*", default=[1, 2, 4, 6, 8, 10])
    p.add_argument("--orth", nargs="*", default=["local", "full", "periodic", "selective"])
    p.add_argument("--max-lanczos", type=int, default=60)
    p.add_argument("--n-wanted", type=int, default=10)
    _add_common(p)

    p = sub.add_parser("info", help="matrix metadata")
    p.add_argument("--mtx", nargs="*", default=[])
    _add_common(p)

    p = sub.add_parser(
        "solve",
        help="route a matrix to the fastest format and solve for extreme "
        "eigenpairs, escalating drivers until converged",
    )
    p.add_argument("--mtx", default=None, help=".mtx file (default: a synthetic spectrum)")
    p.add_argument("--n", type=int, default=2000, help="synthetic matrix size")
    p.add_argument("--cond", type=float, default=1e2, help="synthetic condition number")
    p.add_argument("--n-wanted", type=int, default=10)
    p.add_argument("--which", default="largest",
                   choices=["largest", "smallest"],
                   help="end of the spectrum to target")
    p.add_argument("--s", type=int, default=6)
    p.add_argument("--orth", default="full",
                   choices=["local", "full", "periodic", "selective"])
    p.add_argument("--basis", default="newton", choices=["newton", "monomial"])
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--max-lanczos", type=int, default=60)
    p.add_argument("--max-restarts", type=int, default=200)
    p.add_argument("--prefer", default="auto",
                   choices=["auto", "dense", "dia", "ilv", "pell", "ell"])
    p.add_argument("--max-windows", type=int, default=16)
    p.add_argument("--sw", type=int, default=None, help="PELL window width")
    p.add_argument("--no-reorder", action="store_true",
                   help="disable the RCM reorder-and-retry branch")
    p.add_argument("--engine", default="host", choices=["host", "fused"],
                   help="explicit-restart leg: host state machine or the "
                   "device-resident fused driver")
    p.add_argument("--polish", type=int, default=0, metavar="N",
                   help="two-stage pipeline: N f64 Rayleigh-Ritz polish "
                   "passes on the converged block after the solve "
                   "(device polish for banded f64 sources, host OpenMP "
                   "SpMM otherwise; works on both routes)")
    p.add_argument("--over-lock", type=int, default=0, metavar="K",
                   help="with --polish: lock K extra pairs for the polish "
                   "RR to discard (run the solve at a loose --tol, e.g. "
                   "1e-4, and let the polish set final accuracy)")
    p.add_argument("--cycles-per-call", type=int, default=None,
                   metavar="N",
                   help="accepted for the JAX package's command line and "
                   "ignored by the solve: its relay-safe bursts have no "
                   "counterpart on the card")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="solve row-sharded over N ranks (parallel.dist_solve_auto): one "
        "card each, or gloo CPU ranks with --device cpu",
    )
    p.add_argument(
        "--hosts", type=int, default=0, metavar="H",
        help="with --mesh N: the hierarchical ('host','chip') mesh of H x N/H "
        "ranks (parallel.make_hier_mesh) instead of the flat ring",
    )
    _add_common(p)

    p = sub.add_parser("scaling", help="weak-scaling sweep of the distributed matrix powers")
    p.add_argument("--devices", type=int, nargs="*", default=None)
    p.add_argument("--rows-per-device", type=int, default=1 << 18)
    p.add_argument("--s", type=int, default=8)
    _add_common(p)

    args = ap.parse_args(argv)
    device = args.device

    if args.cmd == "propagation":
        from ca_lanczos_tpu_torch.harness import run_propagation_experiment

        recs = run_propagation_experiment(
            n=args.n, dt=args.dt, n_steps=args.steps, krylov_dim=args.krylov,
            s=args.s, oracle=not args.no_oracle, device=device,
        )
        _emit(recs, args.out)

    elif args.cmd == "sweep":
        import numpy as np

        from ca_lanczos_tpu_torch.harness import run_restart_sweep
        from ca_lanczos_tpu_torch.utils.matrices import diag_spectrum
        from ca_lanczos_tpu_torch.utils.mmio import load_operator

        if args.mtx:
            mats = {path: load_operator(path, device=device) for path in args.mtx}
            oracles = None
        else:
            mats = {
                "diag_1e2": diag_spectrum(1000, 1.0, 1e2, device=device),
                "diag_1e4": diag_spectrum(1000, 1.0, 1e4, device=device),
            }
            oracles = {
                "diag_1e2": np.linspace(1.0, 1e2, 1000),
                "diag_1e4": np.linspace(1.0, 1e4, 1000),
            }
        recs = run_restart_sweep(
            mats, s_values=args.s, orths=args.orth,
            max_lanczos=args.max_lanczos, n_wanted=args.n_wanted, oracles=oracles,
        )
        _emit(recs, args.out)

    elif args.cmd == "info":
        from ca_lanczos_tpu_torch.harness import matrix_info
        from ca_lanczos_tpu_torch.utils.matrices import diag_spectrum
        from ca_lanczos_tpu_torch.utils.mmio import load_operator

        if args.mtx:
            recs = [matrix_info(load_operator(p2, device=device), p2) for p2 in args.mtx]
        else:
            recs = [matrix_info(diag_spectrum(1000, 1.0, 1e2, device=device), "diag_1e2")]
        _emit(recs, args.out)

    elif args.cmd == "solve":
        import numpy as np
        import scipy.sparse as sp

        from ca_lanczos_tpu_torch.config import Basis, LanczosConfig, Orth
        from ca_lanczos_tpu_torch.harness.auto import solve_auto

        if args.mtx:
            from ca_lanczos_tpu_torch.utils.mmio import load_mtx

            ri, ci, vi, (rows, cols) = load_mtx(args.mtx)
            if rows != cols:
                raise SystemExit(f"{args.mtx}: square matrices only")
            a = sp.csr_matrix((vi, (ri, ci)), shape=(rows, cols))
            name = args.mtx
        else:
            d = np.linspace(1.0, args.cond, args.n)
            a = sp.diags(d).tocsr()
            name = f"synthetic diag n={args.n} cond={args.cond:g}"
        cfg = LanczosConfig(
            n_wanted=args.n_wanted, s=args.s,
            orth=Orth[args.orth.upper()], basis=Basis[args.basis.upper()],
            tol=args.tol, max_restarts=args.max_restarts,
        )
        rng = np.random.default_rng(args.seed)
        r = rng.standard_normal(a.shape[0])
        rec = {"matrix": name, "n": int(a.shape[0]), "nnz": int(a.nnz)}
        if args.mesh:
            from ca_lanczos_tpu_torch.parallel.auto import solve_rank
            from ca_lanczos_tpu_torch.parallel.runtime import spawn

            if (args.prefer != "auto" or args.sw is not None
                    or args.max_windows != 16):
                print(
                    "warning: --prefer/--sw/--max-windows apply to the "
                    "single-card route only; the distributed route picks "
                    "its own format (see parallel.route_dist_operator)",
                    file=sys.stderr,
                )
            if args.hosts and args.mesh % args.hosts:
                raise SystemExit(f"--hosts {args.hosts} must divide --mesh {args.mesh}")
            rec.update(spawn(
                solve_rank, args.mesh, device, a, r, args.max_lanczos, cfg, args.hosts,
                dict(which=args.which, polish=args.polish, over_lock=args.over_lock,
                     allow_reorder=not args.no_reorder),
            )[0])
        else:
            res = solve_auto(
                a, r, args.max_lanczos, cfg,
                prefer=args.prefer, max_windows=args.max_windows, sw=args.sw,
                which=args.which, engine=args.engine,
                cycles_per_call=args.cycles_per_call,
                polish=args.polish, over_lock=args.over_lock,
                allow_reorder=not args.no_reorder, device=device,
            )
            rec.update({
                "format": res.route.format if res.route else None,
                "reordered": bool(res.route and res.route.perm is not None),
                "route_notes": res.route.notes if res.route else [],
                "solver": res.solver,
                "escalated": res.escalated,
                "converged": res.converged,
                "n_restarts": res.n_restarts,
                "eigs": [float(v) for v in np.sort(np.asarray(res.eigs))[::-1]],
            })
        _emit([rec], args.out)

    elif args.cmd == "scaling":
        import torch

        from ca_lanczos_tpu_torch.parallel.runtime import scaling_sweep

        visible = torch.cuda.device_count() if device == "cuda" else 1
        counts = args.devices or sorted({1, visible})
        recs = scaling_sweep(counts, rows_per_device=args.rows_per_device, s=args.s,
                             device=device)
        _emit(recs, args.out)

    return 0


if __name__ == "__main__":
    sys.exit(main())
