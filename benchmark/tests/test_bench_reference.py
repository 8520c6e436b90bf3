"""The plain reference against a dense eigh, its certificate and its judge."""

from pathlib import Path

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
REF = harness.load_module(BENCH / "reference" / "koster_slater.py")
RECIPE = harness.load_module(BENCH / "matrices" / "impurity_chain.py")
EPS = [1.0 + 0.125 * j for j in range(16)]


def chain(n, seed, slots=20, gauge=None):
    """Instance ``seed`` of the recipe, in the gauge of seed ``gauge`` (S A S)."""
    a = RECIPE.build(n, seed, 1.0, EPS, slots)
    if gauge is not None:
        s = harness.signature(n, gauge)
        a = sp.diags(s) @ a @ sp.diags(s)
    return sp.csr_matrix(a).astype(np.float32)


def check_pairs(ref, w, U):
    assert np.max(np.abs(ref.theta - w[:10])) <= 1e-14 * w[0]
    assert np.max(ref.resid) < 1e-14 and ref.tau == pytest.approx(w[10], abs=1e-12)
    # each vector lies on its impurity's window, and matches it
    for j in range(10):
        lo, hi = ref.site[j] - ref.half[j], ref.site[j] + ref.half[j] + 1
        at = np.searchsorted(ref.rows, np.arange(lo, hi))
        v = REF.unit_vector(ref.r[j], int(ref.half[j])) * ref.gauge[at]
        assert abs(U[lo:hi, j] @ v) > 1 - 1e-14


def test_reference_agrees_with_dense_eigh():
    n, seed, slots = 18 * 390, 11, 18
    a = chain(n, seed, slots, gauge=2**31 + 9)
    ref = REF.top_pairs(a, 10)
    w, U = np.linalg.eigh(a.toarray().astype(np.float64))
    check_pairs(ref, w[::-1][:11], U[:, ::-1][:, :10])
    assert set(np.flatnonzero(a.diagonal())) == set(RECIPE.sites(n, seed, EPS, slots)[0])


@pytest.mark.parametrize("gauge", [None, 5])
def test_reference_agrees_with_lapack_on_a_longer_chain(gauge):
    n, seed, slots = 1 << 16, 2**31 + 3, 64
    a = chain(n, seed, slots, gauge).astype(np.float64)
    w, U = scipy.linalg.eigh_tridiagonal(a.diagonal(), a.diagonal(1), select="i",
                                         select_range=(n - 11, n - 1))
    check_pairs(REF.top_pairs(a, 10), w[::-1], U[:, ::-1][:, :10])


def test_instances_place_the_same_levels_differently():
    a, b = chain(8000, 1), chain(8000, 2)
    ra, rb = REF.top_pairs(a, 10), REF.top_pairs(b, 10)
    assert np.array_equal(ra.theta, rb.theta) and not np.array_equal(ra.site, rb.site)
    g = REF.top_pairs(chain(8000, 1, gauge=7), 10)
    assert np.array_equal(g.theta, ra.theta) and np.array_equal(g.site, ra.site)
    assert np.array_equal(np.abs(g.gauge), np.ones(g.rows.size)) and np.any(g.gauge < 0)


def test_judge_reads_each_fault():
    a = chain(8000, 5, gauge=3)
    ref = REF.top_pairs(a, 10)
    k, rows = 10, ref.rows
    kept = np.zeros((rows.size, k))
    for j in range(k):
        at = np.searchsorted(rows, np.arange(ref.site[j] - ref.half[j],
                                             ref.site[j] + ref.half[j] + 1))
        kept[at, j] = -REF.unit_vector(ref.r[j], int(ref.half[j])) * ref.gauge[at]
    eigs, out = ref.theta.copy(), np.zeros(k)
    assert REF.judge(ref, eigs[::-1], kept[:, ::-1], out) == {"eig_err": 0.0, "vec_err": 0.0}
    e2 = eigs.copy()
    e2[3] += 1e-6 * eigs[0]
    assert REF.judge(ref, e2, kept, out)["eig_err"] == pytest.approx(1e-6)
    o2 = out.copy()
    o2[5] = 1e-8  # a vector with 1e-4 of its norm off the kept rows
    assert REF.judge(ref, eigs, kept, o2)["vec_err"] == pytest.approx(1e-4)
    k2 = kept.copy()
    other = np.searchsorted(rows, ref.site[1])
    k2[other, 0] = 1e-4  # the first vector leaks onto the second's window
    assert REF.judge(ref, eigs, k2, out)["vec_err"] == pytest.approx(1e-4)
    bad = REF.judge(ref, eigs[:5], kept[:, :5], out[:5])
    assert bad == {"eig_err": np.inf, "vec_err": np.inf}
    k3 = kept.copy()
    k3[0, 0] = np.nan
    assert REF.judge(ref, eigs, k3, out)["vec_err"] == np.inf


def test_no_certificate_off_the_model():
    n = 8000
    a = chain(n, 3).tolil()
    x = int(np.flatnonzero(a.diagonal())[0])
    near = a.copy()
    near[x + 20, x + 20] = 1.5  # a second impurity inside the first's window
    with pytest.raises(ValueError, match="certificate"):
        REF.top_pairs(near.tocsr(), 10)
    hop = a.copy()
    hop[100, 101] = hop[101, 100] = 1.01  # not one hop
    with pytest.raises(ValueError, match="certificate"):
        REF.top_pairs(hop.tocsr(), 10)
    skew = a.copy()
    skew[100, 101] = -1.0  # not symmetric
    with pytest.raises(ValueError, match="certificate"):
        REF.top_pairs(skew.tocsr(), 10)
    few = sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1], format="lil")
    few[n // 2, n // 2] = 2.0
    with pytest.raises(ValueError, match="certificate"):
        REF.top_pairs(few.tocsr(), 10)


def test_control_reads_its_lower_precisions():
    a = chain(8000, 7, gauge=8)
    ref = REF.top_pairs(a, 10)
    for prec, eig_floor in (("float32", 1e-9), ("tf32", 1e-5)):
        eigs, V, rows = REF.control_answer(a, 10, prec, prec)
        assert np.array_equal(rows, ref.rows)
        got = REF.judge(ref, eigs, V, np.zeros(10))
        assert eig_floor < got["eig_err"] < 100 * eig_floor and got["vec_err"] > 1e-7


def test_tf32_rounding():
    x = np.array([1.0, 95.0 + 5.0 / 9.0, 97.2222222, -3.0e-3], np.float32)
    got = REF.tf32_round(x)
    assert got[0] == 1.0 and got[1] == 95.5625 and got[2] == 97.25
    assert abs(got[3] - x[3]) <= 2.0**-11 * abs(x[3])
