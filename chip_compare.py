#!/usr/bin/env python3
"""Time K1, K3 and K4 of two trees of the port on one GPU, in turns.

Run from the root of a checkout, with the other tree unpacked beside it
(for instance the parent commit: ``mkdir -p build/parent && git archive
HEAD~1 ca_lanczos_tpu_torch native | tar -x -C build/parent``):

    python3 chip_compare.py build/parent

Each tree's kernels are timed by a process of its own that imports that
tree's ``ca_lanczos_tpu_torch`` (and builds its kernels into the tree's
``build/kernels``), in the order other, this, this, other, so that a drift
of the card during the call shows as a difference between the two runs of
one tree.  The inputs are chip_smoke.py phase 1's: K1
(``dia_powers_fused``) on bench.py's operator (4,194,304 rows x 9
diagonals, s = 8, Newton coefficients from the bootstrap) and on main path
A's tridiagonal (11,010,048 rows, s = 8); K3 (``dia_powers_ilv``) on
bench.py's operator; K4 (``pell_step``, unit encoding) on the
11,010,048-row PELL oracle matrix; f32 and f64, timed as chip_smoke times
them (``time_ms``: CUDA events around runs of back-to-back calls, median
of 20 runs).  Each run checks its kernels against the plain versions
(chip_smoke's bounds).  The last line is one JSON object {"device": ...,
"runs": [{"tree": ..., "kernels": {...}}, ...]}.

    python3 chip_compare.py --k1-split

splits this tree's register K1 instead, at the same two shapes: it builds
``csrc/dia_powers.cu`` five times (``-DDIA_K1_DROP=0..4``: the kernel,
and builds that never re-stage, skip the steps' reads and arithmetic, skip
the V stores, or store V from the threads instead of bulk copies) and
times each, the kernel at the other number of quads per thread, and a
device copy of the same bytes, in one process.  Without a CUDA device it
exits non-zero.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def k1_shapes(cs) -> dict:
    """K1's two shapes: bench.py's operator and main path A's, each
    (planes, offsets, x) in numpy."""
    data, offsets, x, _ = cs.bench_operator()
    return {"bench": (data, offsets, x), "path_a": cs.path_a_operator()}


def time_tree(root: str, csr_path: str) -> dict:
    """Time K1, K3 and K4 of the package under ``root`` (run in a process
    of its own, so that the two trees' packages never meet)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs

    cs.phase0(torch)
    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_pell, cuda_spmv, pell
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

    assert os.path.dirname(cuda_ilv.__file__).startswith(os.path.abspath(root))
    out = {}
    s = 8
    shapes = k1_shapes(cs)
    for shape, (data, offsets, x) in shapes.items():
        coefs = cs.newton_coefs(torch, data, offsets, x, s)
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[-1]
            D = torch.as_tensor(data, dtype=dt, device="cuda")
            X = torch.as_tensor(x, dtype=dt, device="cuda")
            kern = lambda: cuda_spmv.dia_powers_fused(D, X, coefs, offsets, s)  # noqa: E731
            got, ref = kern(), cuda_spmv.dia_powers_fused_ref(D, X, coefs, offsets, s)
            cs.check_row(torch, "dia_powers_fused", name, got[0], ref[0])
            del got, ref
            out[f"dia_powers_fused/{shape}/{name}"] = cs.time_ms(torch, kern)
            del D, X
    data, offsets, x = shapes["bench"]  # K3's inputs
    coefs = cs.newton_coefs(torch, data, offsets, x, s)
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        D = torch.as_tensor(data, dtype=dt, device="cuda")
        D_il = cuda_ilv.IlvDiaMatrix.from_dia(DiaMatrix(data=D, offsets=offsets),
                                              keep_dia=False).data_il
        X_il = cuda_ilv.ilv_encode(torch.as_tensor(x, dtype=dt, device="cuda")).contiguous()
        kern = lambda: cuda_ilv.dia_powers_ilv(D_il, X_il, coefs, offsets, s)  # noqa: E731
        got, ref = kern(), cuda_ilv.dia_powers_ilv_ref(D_il, X_il, coefs, offsets, s)
        cs.check_row(torch, "dia_powers_ilv", name, got[0], ref[0])
        del got, ref
        out[f"dia_powers_ilv/{name}"] = cs.time_ms(torch, kern)
        del D, D_il, X_il

    with np.load(csr_path) as z:
        import scipy.sparse as sp

        a32 = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
    A32 = pell.PellMatrix.from_scipy(a32, encoding="unit", native=True, device="cuda")
    n = a32.shape[0]
    rng = np.random.default_rng(7)
    xv = np.asarray(rng.standard_normal(n), np.float32)
    vp = np.asarray(rng.standard_normal(n), np.float32)
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        A = A32 if dt == torch.float32 else dataclasses.replace(A32, vals=A32.vals.to(dt))
        X = torch.zeros(A.n_x, dtype=dt, device="cuda")
        P = torch.zeros_like(X)
        X[:n] = torch.as_tensor(xv, dtype=dt, device="cuda")
        P[:n] = torch.as_tensor(vp, dtype=dt, device="cuda")
        kern = lambda: cuda_pell.pell_step(A, X, P, 0.7, -0.3)  # noqa: E731
        cs.check_row(torch, "pell_step_unit", name, kern(), pell.pell_step_ref(A, X, P, 0.7, -0.3))
        out[f"pell_step_unit/{name}"] = cs.time_ms(torch, kern)
        need, full = cs.pell_bytes(torch, A)
        out[f"pell_step_unit/{name}/bytes"] = [need, full]
        del A, X, P
    return out


def k1_split() -> dict:
    """Time this tree's register K1, and builds of it that each drop or
    replace one part (``DIA_K1_DROP``), at both K1 shapes, f32 and f64; the
    kernel also at the other number of quads per thread, and a device copy
    of the same bytes."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs

    cs.phase0(torch)
    from ca_lanczos_tpu_torch.ops import _cuda_build, cuda_spmv

    out_dir = os.path.join(HERE, "build", "k1_split")
    os.makedirs(out_dir, exist_ok=True)
    drops = {0: "kernel", 1: "no_restage", 2: "no_steps", 3: "no_V_stores",
             4: "thread_stores"}

    def build(drop):
        so = os.path.join(out_dir, f"libdia_powers_drop{drop}.so")
        cmd = [_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, f"-DDIA_K1_DROP={drop}", "-I",
               str(_cuda_build.CSRC), "-o", so, str(_cuda_build.CSRC / "dia_powers.cu")]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(so)
        for fn, (argtypes, restype) in cuda_spmv._SIGS.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        return drop, lib

    with ThreadPoolExecutor(len(drops)) as pool:
        libs = dict(pool.map(build, drops))
    out = {}
    s = 8
    for shape, (data, offsets, x) in k1_shapes(cs).items():
        coefs = cs.newton_coefs(torch, data, offsets, x, s)
        offs = (ctypes.c_int * len(offsets))(*offsets)
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[-1]
            D = torch.as_tensor(data, dtype=dt, device="cuda")
            X = torch.as_tensor(x, dtype=dt, device="cuda")
            n = X.shape[0]
            V = torch.empty((s, n), dtype=dt, device="cuda")
            last = torch.empty_like(X)
            ref = cuda_spmv.dia_powers_fused_ref(D, X, coefs, offsets, s)[0]
            plan = cuda_spmv.k1_plan_for(offsets, s, dt)
            item = D.element_size()
            runs = [(label, drop, plan.quads) for drop, label in drops.items()]
            runs += [(f"quads={q}", 0, q) for q in (1, 2) if q != plan.quads]
            for label, drop, quads in runs:
                window = 4 * cuda_spmv.K1_THREADS * quads
                tile = window - 2 * plan.halo
                if tile < max(4, plan.halo) or cuda_spmv.k1_smem(
                        len(offsets), window, plan.bw, item) > cuda_spmv.SMEM_MAX:
                    continue
                fn = getattr(libs[drop], f"dia_powers_fused_{'f32' if item == 4 else 'f64'}")

                def kern():
                    rc = fn(D.data_ptr(), offs, len(offsets), X.data_ptr(), coefs.ctypes.data,
                            V.data_ptr(), last.data_ptr(), n, s, tile, plan.halo, plan.bw,
                            quads, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"K1 {label} launch failed: CUDA error {rc}")

                kern()
                torch.cuda.synchronize()
                if drop in (0, 4):
                    cs.check_row(torch, f"dia_powers_fused {label}", name, V, ref)
                out[f"{shape}/{name}/{label}"] = cs.time_ms(torch, kern)
                cs.log(f"k1 split {shape} [{name}] {label} (tile {tile}, halo {plan.halo}, "
                       f"bw {plan.bw}): {out[f'{shape}/{name}/{label}']:.4f} ms")
            # yardstick: a device copy moving as many bytes as K1's bound
            # counts, half read and half written
            half = (len(offsets) + 1 + s + 1) * n // 2
            src = torch.empty(half, dtype=dt, device="cuda")
            dst = torch.empty_like(src)
            out[f"{shape}/{name}/copy_same_bytes"] = cs.time_ms(torch, lambda: dst.copy_(src))
            cs.log(f"k1 split {shape} [{name}] copy of the same bytes: "
                   f"{out[f'{shape}/{name}/copy_same_bytes']:.4f} ms")
            del D, X, V, last, ref, src, dst
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        print(json.dumps(time_tree(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_compare.py: no CUDA device visible; this script needs one GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1] == "--k1-split":
        print(json.dumps({"k1_split": k1_split()}))
        return 0
    import chip_smoke as cs

    other = os.path.abspath(sys.argv[1])
    if not os.path.isfile(os.path.join(other, "ca_lanczos_tpu_torch", "__init__.py")):
        print(f"chip_compare.py: no ca_lanczos_tpu_torch under {other}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    a, _ = cs.pell_operator(cs.PELL_N)
    a32 = a.astype(np.float32)
    del a
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        csr_path = os.path.join(tmp, "pell_csr.npz")
        np.savez(csr_path, data=a32.data, indices=a32.indices, indptr=a32.indptr,
                 shape=np.asarray(a32.shape))
        del a32
        for root in (other, HERE, HERE, other):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root,
                                   csr_path], capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"timing run of {root} failed ({proc.returncode})")
            times = json.loads(proc.stdout.strip().splitlines()[-1])
            tree = "this" if root == HERE else os.path.relpath(root, HERE)
            runs.append({"tree": tree, "kernels": times})
            print(f"{tree}: " + " ".join(f"{k}={v:.4f}ms" for k, v in times.items()
                                         if not k.endswith("/bytes")), flush=True)
    print(json.dumps({"device": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
