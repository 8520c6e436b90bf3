"""The byte and operation counts of the kernel rooflines, by hand."""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import devtrace, harness, yardstick

METRICS = Path(__file__).resolve().parents[1] / "metrics"
PEAKS = {"bytes_per_s": 1e9, "flops_per_s": {"float32": 1e9, "float64": 5e8}}


def tridiag(n):
    return sp.diags([np.ones(n - 1), 2 * np.ones(n), np.ones(n - 1)], [-1, 0, 1], format="csr")


def scattered():
    """6 x 6, symmetric, 14 entries on 7 diagonals (offsets -4, -2, -1, 0, 1, 2, 4)."""
    a = np.diag(np.arange(1.0, 7.0))
    for i, j in ((0, 4), (1, 2), (3, 5), (4, 5)):
        a[i, j] = a[j, i] = 0.5
    return sp.csr_matrix(a)


def fake_run(facts, ops, s=8):
    return harness.Run(setup_s=0, window_s=1, solves=[], peak_bytes=0, traffic={"s": s},
                       matrix=facts, device_ops=ops, peaks=PEAKS)


def test_facts_of_a_tridiagonal():
    m = yardstick.matrix_facts(tridiag(10))
    assert (m.n, m.nnz, m.diagonals) == (10, 28, 3)
    # planes 3 * 10 * 4 = 120 bytes against CSR 28 * 8 + 11 * 4 = 268
    assert yardstick.matrix_bytes(m, 4) == 120
    assert yardstick.matrix_bytes(m, 8) == 240


def test_facts_of_scattered_sparsity():
    m = yardstick.matrix_facts(scattered())
    assert (m.n, m.nnz, m.diagonals) == (6, 14, 7)
    # planes 7 * 6 * 4 = 168 against CSR 14 * 8 + 7 * 4 = 140
    assert yardstick.matrix_bytes(m, 4) == 140


def test_k1_bound_counts_s_outputs():
    k1 = harness.load_module(METRICS / "k1_roofline.py")
    m = yardstick.matrix_facts(tridiag(10))
    # a launch: 120 (planes) + 40 (x) + 8 * 40 (outputs) = 480 bytes -> 480 ns;
    # 2 * 28 * 8 = 448 operations -> 448 ns; two launches of 960 ns each
    ops = [("dia_powers_reg<float, 2, 4, 1>", 0.0, 960e-9),
           ("dia_powers_reg<float, 2, 4, 1>", 1e-6, 1e-6 + 960e-9),
           ("dia_powers_reg<double, 2, 4, 1>", 2e-6, 3e-6),
           ("dia_power_step_kernel<float>", 3e-6, 4e-6)]
    assert k1.read(fake_run(m, ops)) == pytest.approx(50.0)


def test_k1_bound_reads_the_matrix_not_the_encoding():
    """A chain of 10 with one impurity: 19 entries on 3 diagonals, whose
    planes (3 * 10 * 4 = 120 bytes) beat its CSR arrays (19 * 8 + 44)."""
    k1 = harness.load_module(METRICS / "k1_roofline.py")
    off = np.ones(9)
    a = sp.diags([off, off], [-1, 1], format="csr") + sp.csr_matrix(([2.0], ([4], [4])), (10, 10))
    m = yardstick.matrix_facts(a)
    assert (m.n, m.nnz, m.diagonals) == (10, 19, 3)
    # a launch: 120 + 40 + 8 * 40 = 480 bytes -> 480 ns against 2 * 19 * 8 = 304 ns
    ops = [("dia_powers_band<float, 4, 2, 1>", 0.0, 960e-9)]
    assert k1.read(fake_run(m, ops)) == pytest.approx(50.0)


def test_roofline_reads_nothing_without_launches_or_peaks():
    k1 = harness.load_module(METRICS / "k1_roofline.py")
    m = yardstick.matrix_facts(tridiag(10))
    assert k1.read(fake_run(m, [("dia_power_step_kernel<float>", 0.0, 1.0)])) is None
    run = fake_run(m, [("dia_powers_reg<float, 2, 4, 1>", 0.0, 1.0)])
    run.peaks = None
    assert k1.read(run) is None
    assert k1.read(harness.Run(setup_s=0, window_s=1, solves=[], peak_bytes=0,
                               traffic={"s": 8})) is None


def test_device_union_gaps_and_names():
    ops = [("void a<float>(float const*, int)", 0.0, 1.0), ("b", 0.5, 2.0),
           ("a<float>", 3.0, 4.0)]
    assert devtrace.busy_seconds(ops) == pytest.approx(3.0)
    assert devtrace.short_name(ops[0][0]) == "a<float>"
    assert devtrace.short_name("void at::native::(anonymous namespace)::k<float>(float*)") == \
        "at::native::k<float>"
    stages = devtrace.stage_spans([("bench.solve", 0.0, 5.0)],
                                  [{"route": 3.0, "solve": 2.0}])
    bd = devtrace.breakdown(ops, 0.0, 5.0, stages)
    assert bd["device_ops"][0] == ["a<float>", 2.0]
    assert bd["idle_gaps"] == [["route", 1.0], ["solve", 1.0]]
    idle = harness.load_module(METRICS / "device_idle.py")
    run = fake_run(None, ops)
    run.busy_s, run.window_s = 3.0, 5.0
    assert idle.read(run) == pytest.approx(40.0)
