#!/usr/bin/env python3
"""Time K3 and K4 of two trees of the port on one GPU, in turns.

Run from the root of a checkout, with the other tree unpacked beside it
(for instance the parent commit: ``mkdir -p build/parent && git archive
HEAD~1 ca_lanczos_tpu_torch native | tar -x -C build/parent``):

    python3 chip_compare.py build/parent

Each tree's kernels are timed by a process of its own that imports that
tree's ``ca_lanczos_tpu_torch`` (and builds its kernels into the tree's
``build/kernels``), in the order other, this, this, other, so that a drift
of the card during the call shows as a difference between the two runs of
one tree.  The inputs are chip_smoke.py phase 1's: K3 (``dia_powers_ilv``)
on bench.py's operator (4,194,304 rows x 9 diagonals, s = 8, Newton
coefficients from the bootstrap) and K4 (``pell_step``, unit encoding) on
the 11,010,048-row PELL oracle matrix; f32 and f64, timed as chip_smoke
times them (``time_ms``: CUDA events around runs of back-to-back calls,
median of 20 runs).  Each run checks its kernels against the plain
versions (chip_smoke's bounds).  The last line is one JSON object
{"device": ..., "runs": [{"tree": ..., "kernels": {...}}, ...]}.  Without a
CUDA device it exits non-zero.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def time_tree(root: str, csr_path: str) -> dict:
    """Time K3 and K4 of the package under ``root`` (run in a process of
    its own, so that the two trees' packages never meet)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs

    cs.phase0(torch)
    from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_pell, pell
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

    assert os.path.dirname(cuda_ilv.__file__).startswith(os.path.abspath(root))
    out = {}
    s = 8
    data, offsets, x, _ = cs.bench_operator()
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
