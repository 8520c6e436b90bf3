#!/usr/bin/env python3
"""Time K1, K3, K4 and K5 of two trees of the port on one GPU, in turns.

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
bench.py's operator; K4 and K5 (``pell_step``; unit, grouped and grouped4
encodings) on the 11,010,048-row PELL oracle matrix, each with the
tree's ``pell_step_bytes`` (the bytes the step needs, the full planes);
f32 and f64; and K1 at phase H's DIA form (10,485,760 rows, 31 diagonals
inside +-15, f32, s = 2, 4, 8, 16, Newton coefficients) and at phase
K(c)'s f64 shard (the same planes with 60 zero rows a side, s = 4).  All
are timed as chip_smoke times them (``time_ms``: CUDA events around runs
of back-to-back calls, median of 20 runs).  Each run checks its kernels
against the plain versions (chip_smoke's bounds).  The last line is one
JSON object {"device": ..., "runs": [{"tree": ..., "kernels": {...}},
...]}: "device" is nvidia-smi's name and power limit.

    python3 chip_compare.py --k1-split

splits this tree's register K1 instead, at the same two shapes and at the
wide-band kernel's (phase H's DIA form at s = 4 and 16, f32; K(c)'s f64
shard at s = 4): it builds ``csrc/dia_powers.cu`` five times
(``-DDIA_K1_DROP=0..4``: the kernel, and builds that never re-stage, skip
the steps' reads and arithmetic, skip the V stores, or store V from the
threads instead of bulk copies) and times each, the kernel at the other
number of vectors per thread where that fits, and a device copy of the
same bytes, in one process.  Without a CUDA device it exits non-zero.
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
    """Time K1, K3, K4 and K5 of the package under ``root`` (run in a
    process of its own, so that the two trees' packages never meet)."""
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
    n = a32.shape[0]
    rng = np.random.default_rng(7)
    xv = np.asarray(rng.standard_normal(n), np.float32)
    vp = np.asarray(rng.standard_normal(n), np.float32)
    for enc in ("unit", "grouped", "grouped4"):
        A32 = pell.PellMatrix.from_scipy(a32, encoding=enc, native=True, device="cuda")
        kname = "pell_step_unit" if enc == "unit" else f"pell_step_grouped/{enc}"
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[-1]
            A = A32 if dt == torch.float32 else dataclasses.replace(A32, vals=A32.vals.to(dt))
            X = torch.zeros(A.n_x, dtype=dt, device="cuda")
            P = torch.zeros_like(X)
            X[:n] = torch.as_tensor(xv, dtype=dt, device="cuda")
            P[:n] = torch.as_tensor(vp, dtype=dt, device="cuda")
            kern = lambda: cuda_pell.pell_step(A, X, P, 0.7, -0.3)  # noqa: E731
            cs.check_row(torch, kname, name, kern(), pell.pell_step_ref(A, X, P, 0.7, -0.3))
            out[f"{kname}/{name}"] = cs.time_ms(torch, kern)
            out[f"{kname}/{name}/bytes"] = list(pell.pell_step_bytes(A))
            del A, X, P
        del A32
        torch.cuda.empty_cache()

    # K1 at phase H's DIA form (31 diagonals inside +-15, f32) and at phase
    # K(c)'s f64 shard (the same planes with 60 zero rows a side, s = 4,
    # zero coefficients, as parallel/smoke.py kernel_rows runs it)
    B, _ = cs.bsr_operator(torch)
    D = B.to_dia()
    del B
    offsets = tuple(D.offsets)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(D.data.shape[1]),
                        dtype=torch.float32, device="cuda")
    x /= torch.linalg.norm(x)
    for s in (2, 4, 8, 16):
        coefs = cs.newton_coefs(torch, D.data, offsets, x, s)
        kern = lambda: cuda_spmv.dia_powers_fused(D.data, x, coefs, offsets, s)  # noqa: E731
        got, ref = kern(), cuda_spmv.dia_powers_fused_ref(D.data, x, coefs, offsets, s)
        cs.check_row(torch, "dia_powers_fused (H)", "float32", got[0], ref[0])
        del got, ref
        out[f"dia_powers_fused/bsr_dia/s{s}/float32"] = cs.time_ms(torch, kern)
    del x
    D64 = torch.nn.functional.pad(D.data.double(), (60, 60))
    del D
    torch.cuda.empty_cache()
    x64 = torch.as_tensor(np.random.default_rng(2).standard_normal(D64.shape[1]),
                          device="cuda")
    zeros = np.zeros((4, 2))
    kern = lambda: cuda_spmv.dia_powers_fused(D64, x64, zeros, offsets, 4)  # noqa: E731
    got, ref = kern(), cuda_spmv.dia_powers_fused_ref(D64, x64, zeros, offsets, 4)
    cs.check_row(torch, "dia_powers_fused (K(c))", "float64", got[0], ref[0])
    del got, ref
    out["dia_powers_fused/kc_shard/s4/float64"] = cs.time_ms(torch, kern)
    return out


def k1_split() -> dict:
    """Time this tree's register K1, and builds of it that each drop or
    replace one part (``DIA_K1_DROP``), at both K1 shapes (s = 8, f32 and
    f64) and at the wide-band kernel's (phase H's DIA form, f32, s = 4 and
    16; K(c)'s f64 shard, s = 4); the kernel also at the other number of
    vectors per thread where that fits, and a device copy of the same
    bytes."""
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
    f32, f64 = torch.float32, torch.float64
    # (label, planes, offsets, x, s, dtypes)
    cases = [(shape, data, offsets, x, 8, (f32, f64))
             for shape, (data, offsets, x) in k1_shapes(cs).items()]
    B, _ = cs.bsr_operator(torch)
    D = B.to_dia()
    del B
    xh = np.random.default_rng(1).standard_normal(D.data.shape[1])
    cases += [(f"bsr_dia_s{s}", D.data, tuple(D.offsets), xh, s, (f32,)) for s in (4, 16)]
    cases.append(("kc_shard", torch.nn.functional.pad(D.data.double(), (60, 60)),
                  tuple(D.offsets), np.random.default_rng(2).standard_normal(
                      D.data.shape[1] + 120), 4, (f64,)))
    del D
    out = {}
    for shape, data, offsets, x, s, dtypes in cases:
        coefs = cs.newton_coefs(torch, data, offsets, x, s)
        offs = (ctypes.c_int * len(offsets))(*offsets)
        for dt in dtypes:
            name = str(dt).split(".")[-1]
            D = torch.as_tensor(data, dtype=dt, device="cuda")
            X = torch.as_tensor(x, dtype=dt, device="cuda")
            n = X.shape[0]
            V = torch.empty((s, n), dtype=dt, device="cuda")
            last = torch.empty_like(X)
            ref = cuda_spmv.dia_powers_fused_ref(D, X, coefs, offsets, s)[0]
            plan = cuda_spmv.k1_plan_for(offsets, s, dt)
            item = D.element_size()
            runs = [(label, drop, plan.vecs) for drop, label in drops.items()]
            runs += [(f"vecs={q}", 0, q) for q in (1, 2) if q != plan.vecs]
            for label, drop, vecs in runs:
                window = plan.rows * cuda_spmv.K1_THREADS * vecs
                tile = window - 2 * plan.halo
                if tile < max(4, plan.halo) or cuda_spmv.k1_smem(
                        len(offsets), window, plan.bw, item) > cuda_spmv.SMEM_MAX:
                    continue
                fn = getattr(libs[drop], f"dia_powers_fused_{'f32' if item == 4 else 'f64'}")

                def kern():
                    rc = fn(D.data_ptr(), offs, len(offsets), X.data_ptr(), coefs.ctypes.data,
                            V.data_ptr(), last.data_ptr(), n, s, tile, plan.halo, plan.bw,
                            vecs, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"K1 {label} launch failed: CUDA error {rc}")

                kern()
                torch.cuda.synchronize()
                if drop in (0, 4):
                    cs.check_row(torch, f"dia_powers_fused {label}", name, V, ref)
                out[f"{shape}/{name}/{label}"] = cs.time_ms(torch, kern)
                cs.log(f"k1 split {shape} [{name}] {label} ({plan.variant}, tile {tile}, halo "
                       f"{plan.halo}, bw {plan.bw}): {out[f'{shape}/{name}/{label}']:.4f} ms")
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
            print(f"{tree} bytes: " + " ".join(f"{k}={v}" for k, v in times.items()
                                               if k.endswith("/bytes")), flush=True)
    print(json.dumps({"device": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
