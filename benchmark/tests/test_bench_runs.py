"""Runs of the harness on the port's plain CPU path at a small n: a whole
run, the command's refusals, the faults that ``correct`` must catch, and
the control that it must fail.  The control at the cells' own size needs
the card (``requires_cuda``)."""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
N = 1 << 15
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

DRY = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
res = harness.run_cell(harness.load_cell({cell!r}), 2**31 + 17, 0.1, {trace}, time.perf_counter(),
                       device="cpu", n={n})
print(json.dumps({{"result": res, "forbidden": sorted(
    {{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "ca_lanczos_tpu"}})}}))
"""


@pytest.mark.parametrize("cell,trace", [(c, t) for c in CELLS for t in (0, 1)])
def test_dry_run_is_correct_and_loads_no_jax(cell, trace):
    out = subprocess.run([sys.executable, "-c", DRY.format(root=str(ROOT), cell=cell,
                                                           trace=trace, n=N)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    res = got["result"]
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    if trace:
        assert {"restarts", "stage_route_s", "stage_probe_s", "stage_solve_s",
                "stage_polish_s"} <= names
        assert not names & {"k1_roofline", "device_idle"}  # no device: nothing to read
    else:
        assert names == {"time_to_solution_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("instance", [1, 2, 3])
def test_other_instances_are_correct(instance):
    """The timed instance is fixed; others of the recipe are read correct too."""
    cell = harness.load_cell(CELLS[0])
    cell = dataclasses.replace(cell, config=dict(cell.config, recipe_seed=instance))
    res = harness.run_cell(cell, 2**31 + instance, 0.01, False, time.perf_counter(),
                           device="cpu", n=N)
    assert res["correct"] and res["failed"] == 0


def test_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cmd = [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    # a directory that holds only BENCHMARK.json and the benchmark
    subprocess.run(["cp", "-r", str(ROOT / "benchmark"), str(ROOT / "BENCHMARK.json"),
                    str(tmp_path)], check=True)
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def shift_eig(call):
    def broken():
        res = call()
        res.eigs = np.array(res.eigs, np.float64)
        res.eigs[0] *= 1 + 1e-3
        return res
    return broken


def alter_vector(call):
    def broken():
        res = call()
        res.Q_conv = res.Q_conv.clone()
        res.Q_conv[int(res.Q_conv[:, 0].abs().argmax()), 0] += 1e-2
        return res
    return broken


def half_the_pairs(call):
    def broken():
        res = call()
        k = len(res.eigs) // 2
        res.eigs, res.Q_conv = np.asarray(res.eigs)[:k], res.Q_conv[:, :k]
        return res
    return broken


def unpolished(monkeypatch):
    """The polish returns the block it was given, unchanged, with its
    Rayleigh quotients."""
    from ca_lanczos_tpu_torch.solvers import polish

    def same(A64, X, iters=3, depth=4):
        w, resid, _ = polish._rq64(A64, X.float())
        return w.cpu().numpy(), resid.cpu().numpy(), X.float()

    monkeypatch.setattr(polish, "rayleigh_ritz_polish", same)


FAULTS = [(c, f) for c in CELLS
          for f in ("shift_eig", "alter_vector", "half_the_pairs", "unpolished")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    wrap = None
    if fault == "unpolished":
        unpolished(monkeypatch)
    else:
        wrap = globals()[fault]
    res = harness.run_cell(harness.load_cell(cell), 3, 0.01, False, time.perf_counter(),
                           device="cpu", n=N, wrap=wrap)
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    c = harness.load_cell(cell)
    for seed in (1, 2, 3):
        got = harness.control_numbers(c, seed, device="cpu", n=N)
        assert any(got[k] > lim for k, lim in c.limits.items()), got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control at the cell's own size")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit_at_full_size(cell, card):
    c = harness.load_cell(cell)
    for seed in (11, 12, 13):
        got = harness.control_numbers(c, seed)
        print(cell, seed, got)
        assert any(got[k] > lim for k, lim in c.limits.items()), got
