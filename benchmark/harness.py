"""One run of one cell of the benchmark of ``ca_lanczos_tpu_torch``.

A cell names a configuration (``configs/<name>.json``: the matrix recipe
in ``matrices/<recipe>.py``, its instance, size, dtype and route) and a traffic mix
(``traffic/<name>.json``: the arguments of ``solve_auto``).  The run
builds the matrix in the seed's gauge, warms up with one solve as the
traffic's ``warm_up`` changes it (the same shapes, less work), then
calls ``solve_auto`` back to back for the window, as a user who waits for
each result does, and keeps of every answer what the reference needs.
After the window the reference (``reference/<name>.py``) rebuilds the
matrix from the seed, works out the wanted pairs itself and judges every
answer against the limits of ``limits/<cell>.json``.  Every metric is a
reader in ``metrics/<name>.py``; ``BENCHMARK.json`` says which ones a
cell reports.  With ``trace`` the window runs under ``torch.profiler``,
held in memory, and the per-layer metrics are read from it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from benchmark import devtrace, yardstick

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ca_lanczos_tpu"}
CHUNK = 1 << 20  # rows a step when summing an answer's squares outside the kept rows


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path):
    """The module in ``path`` (a recipe, reference or metric), found by name."""
    name = f"benchmark.{path.parent.name}.{path.stem}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files and the metrics it
    reports: every end-to-end metric, and the per-layer metrics whose
    ``workloads`` list the cell."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    e2e = list(bench["end_to_end"])
    per = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(BENCH / "configs" / f"{w['config']}.json"),
                traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def signature(n: int, seed: int) -> np.ndarray:
    """The run's +-1 gauge s, drawn from the seed."""
    rng = np.random.default_rng(seed & (2**64 - 1))
    return rng.integers(0, 2, n).astype(np.float64) * 2.0 - 1.0


def build_matrix(config: dict, seed: int, n: Optional[int] = None,
                 recipe_seed: Optional[int] = None):
    """The configuration's matrix in the run's gauge, in its dtype (scipy
    CSR): the recipe's instance A (``recipe_seed``, by default the
    configuration's) as S A S, S = diag(s) from the seed.  S A S poses A's
    problem and, with the start vector S 1, runs A's arithmetic with the
    signs of rows flipped, exactly: every seed times the same work."""
    recipe = load_module(BENCH / "matrices" / f"{config['recipe']}.py")
    inst = config["recipe_seed"] if recipe_seed is None else recipe_seed
    a = recipe.build(int(n or config["n"]), inst, **config["params"]).tocsr()
    if n is None and a.nnz != config["nnz"]:
        raise ValueError(f"{config['name']}: the recipe gave {a.nnz} entries, not {config['nnz']}")
    s = signature(a.shape[0], seed)
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    a.data *= s[rows] * s[a.indices]
    return a.astype(np.dtype(config["dtype"]))


def make_call(a, config: dict, traffic: dict, device: str, seed: int) -> Callable:
    """One ``solve_auto`` on ``a`` as the traffic mix asks, as a user calls it."""
    from ca_lanczos_tpu_torch.config import LanczosConfig
    from ca_lanczos_tpu_torch.harness.auto import solve_auto

    if traffic["start"] != "ones":
        raise ValueError(f"unknown start vector {traffic['start']!r}")
    r0 = signature(a.shape[0], seed)  # S 1: the start vector of ones in the gauge
    cfg = LanczosConfig(n_wanted=traffic["n_wanted"], s=traffic["s"], tol=traffic["tol"],
                        max_restarts=traffic["max_restarts"])

    def call():
        return solve_auto(a, r0, traffic["max_lanczos"], cfg, engine=traffic["engine"],
                          which=traffic["which"], polish=traffic["polish"],
                          over_lock=traffic["over_lock"], device=device, **config["route"])

    return call


def keep(eigs, Q, rows: np.ndarray, outside) -> dict:
    """What the reference needs of one answer: its values, its vectors'
    ``rows`` (f64, host), and the sums of squares of their other rows
    (f64, summed on the answer's device; ``outside`` is 1.0 off ``rows``
    and 0.0 on them, a column on that device).  A Q of the wrong shape
    keeps no rows, which the judge reads as a failure."""
    import torch

    out = {"eigs": np.asarray(eigs, np.float64).ravel(), "kept": None, "out_sq": None}
    n = outside.shape[0]
    if isinstance(Q, torch.Tensor) and Q.ndim == 2 and Q.shape[0] == n:
        out["kept"] = Q[torch.as_tensor(rows, device=Q.device)].double().cpu().numpy()
        acc = torch.zeros(Q.shape[1], dtype=torch.float64, device=Q.device)
        for lo in range(0, n, CHUNK):
            hi = min(lo + CHUNK, n)
            acc += (Q[lo:hi].double().square() * outside[lo:hi]).sum(dim=0)
        out["out_sq"] = acc.cpu().numpy()
    return out


def outside_of(rows: np.ndarray, n: int, device: str):
    """The column ``keep`` weighs an answer's squares with."""
    import torch

    w = torch.ones((n, 1), dtype=torch.float64, device=device)
    w[torch.as_tensor(rows, device=device)] = 0.0
    return w


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    window_s: float
    solves: List[dict]
    peak_bytes: int
    traffic: dict
    matrix: Optional[yardstick.MatrixFacts] = None
    device_ops: Optional[list] = None
    busy_s: Optional[float] = None
    peaks: Optional[dict] = None


def read_metrics(entries: List[dict], run: Run) -> dict:
    out = {}
    for m in entries:
        v = load_module(BENCH / "metrics" / f"{m['name']}.py").read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", n: Optional[int] = None,
             wrap: Optional[Callable[[Callable], Callable]] = None) -> dict:
    """One run; returns the result object (the result keys, then
    ``checks``).  ``n`` and ``device`` serve the CPU tests; ``wrap``
    lets a test break the timed path underneath."""
    import torch

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    ref_mod = load_module(BENCH / "reference" / f"{cell.config['reference']}.py")
    a = build_matrix(cell.config, seed, n)
    n = a.shape[0]
    rows = ref_mod.keep_rows(a)
    outside = outside_of(rows, n, device)
    log(f"matrix: {cell.config['name']} n={n} nnz={a.nnz} dtype={a.dtype} "
        f"built at {time.perf_counter() - t_start:.3f}s")
    call = make_call(a, cell.config, cell.traffic, device, seed)
    warm = make_call(a, cell.config, dict(cell.traffic, **cell.traffic["warm_up"]), device,
                     seed)
    if wrap is not None:
        call, warm = wrap(call), wrap(warm)

    t = time.perf_counter()
    res = warm()
    sync()
    keep(res.eigs, res.Q_conv, rows, outside)
    del res
    log(f"warm-up solve: {time.perf_counter() - t:.3f}s")
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts):  # the profiler's own first start-up
            torch.ones(1, device=device).sum().item()
        prof = profile(activities=acts)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    answers: List[dict] = []
    solve_error = None
    setup_s = time.perf_counter() - t_start
    if prof is not None:
        prof.start()
        win = record_function(devtrace.WINDOW_SPAN)
        win.__enter__()
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        try:
            if prof is not None:
                with record_function(devtrace.SOLVE_SPAN):
                    res = call()
            else:
                res = call()
            sync()
        except Exception:  # the answer never comes: record it and close the window
            solve_error = traceback.format_exc()
            log(solve_error)
            break
        dur = time.perf_counter() - ts
        ans = keep(res.eigs, res.Q_conv, rows, outside)
        ans.update(seconds=dur, converged=bool(res.converged), n_restarts=int(res.n_restarts),
                   stage_seconds=dict(res.stage_seconds))
        del res
        answers.append(ans)
        if time.perf_counter() - t0 + dur > seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    if prof is not None:
        win.__exit__(None, None, None)
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for i, ans in enumerate(answers):
        log(f"solve {i}: {ans['seconds']:.4f}s restarts={ans['n_restarts']} "
            f"converged={ans['converged']} stages "
            + " ".join(f"{k}={v:.4f}" for k, v in ans["stage_seconds"].items()))

    run = Run(setup_s=setup_s, window_s=window_s, solves=answers, peak_bytes=int(peak),
              traffic=cell.traffic)
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if prof is not None:
        run.matrix = yardstick.matrix_facts(a)
        device_ops, spans = devtrace.events(prof)
        del prof
        lo, hi = devtrace.window_of(spans)
        run.device_ops = devtrace.clip(device_ops, lo, hi)
        run.window_s = hi - lo
        run.busy_s = devtrace.busy_seconds(run.device_ops) if cuda else None
        run.peaks = yardstick.peaks_for(dev["kind"])
        dev.update(busy_s=run.busy_s, window_s=run.window_s)
        solves = sorted((s for s in spans if s[0] == devtrace.SOLVE_SPAN), key=lambda s: s[1])
        stages = devtrace.stage_spans(solves, [x["stage_seconds"] for x in answers])
        if cuda:
            breakdown = devtrace.breakdown(run.device_ops, lo, hi, stages)
    del call, warm, a, outside
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, run)

    # the reference, on its own matrix from the seed, after the window
    t = time.perf_counter()
    numbers = {name: 0.0 for name in cell.limits}
    try:
        ref = ref_mod.top_pairs(build_matrix(cell.config, seed, n), cell.traffic["n_wanted"])
    except ValueError as exc:  # no certificate: no reference, so nothing is correct
        ref = None
        log(f"reference: {exc}")
    failed = 1 if solve_error else 0
    for i, ans in enumerate(answers):
        got = (ref_mod.judge(ref, ans["eigs"], ans["kept"], ans["out_sq"]) if ref is not None
               else {k: float("inf") for k in cell.limits})
        bad = not ans["converged"] or any(got[k] > lim for k, lim in cell.limits.items())
        failed += int(bad)
        log(f"solve {i}: " + " ".join(f"{k}={v:.6e}" for k, v in got.items())
            + (" FAILED" if bad else ""))
        for k in cell.limits:
            numbers[k] = max(numbers[k], got[k])
    attempted = len(answers) + (1 if solve_error else 0)
    log(f"reference and comparison: {time.perf_counter() - t:.3f}s")
    if cuda:
        log(f"nvidia-smi: {_smi()}")
    correct = bool(answers) and ref is not None and failed == 0
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def control_numbers(cell: Cell, seed: int, device: str = "cuda",
                    n: Optional[int] = None) -> dict:
    """The control: the reference, in the program's place, computing each
    output one precision below the one the traffic states for it, at the
    cell's size, kept and judged as an answer of the window is."""
    import torch

    ref_mod = load_module(BENCH / "reference" / f"{cell.config['reference']}.py")
    a = build_matrix(cell.config, seed, n)
    k = cell.traffic["n_wanted"]
    below = ref_mod.BELOW
    eigs, V, rows = ref_mod.control_answer(a, k, below[cell.traffic["precision"]["eigs"]],
                                           below[cell.traffic["precision"]["vectors"]])
    Q = torch.zeros((a.shape[0], k), dtype=torch.float32, device=device)
    Q[torch.as_tensor(rows, device=device)] = torch.from_numpy(V).to(device)
    ans = keep(eigs, Q, rows, outside_of(rows, a.shape[0], device))
    del Q
    ref = ref_mod.top_pairs(a, k)
    return ref_mod.judge(ref, ans["eigs"], ans["kept"], ans["out_sq"])


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv: List[str], t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        log("benchmark: torch.cuda.is_available() is false; the benchmark needs the card")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"benchmark: {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 3
    log(f"host: {len(os.sched_getaffinity(0))} cores visible, torch threads "
        f"{torch.get_num_threads()}, OMP_NUM_THREADS={os.environ.get('OMP_NUM_THREADS')}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        log(f"benchmark: the process holds {found} after the window; no result")
        return 4
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']:.6e} limit {c['limit']:.6e}")
    print(json.dumps(result), flush=True)
    return 0
