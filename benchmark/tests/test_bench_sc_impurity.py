"""The simple-cubic impurity lattice's Green's-function reference: its
closed forms against direct sums, its levels and vectors against a dense
eigh, its kept rows, its certificate, its judge and its control."""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
REF = harness.load_module(BENCH / "reference" / "sc_impurity.py")
RECIPE = harness.load_module(BENCH / "matrices" / "impurity_sc.py")
CONFIG = harness.load_json(BENCH / "configs" / "impurity-sc216.json")
EPS = CONFIG["params"]["eps"]


def lattice(L, instance=0, gauge=None):
    a = RECIPE.build(L ** 3, instance, 1.0, EPS, 3)
    if gauge is not None:
        s = harness.signature(L ** 3, gauge)
        a = sp.diags(s) @ a @ sp.diags(s)
    return sp.csr_matrix(a)


@pytest.mark.parametrize("L", [9, 10])
def test_green_closed_forms_against_direct_sums(L):
    g = REF._Green(L)
    k = 2 * np.pi * np.arange(L) / L
    e = 6.7
    eps = (2 * np.cos(k))[:, None, None] + (2 * np.cos(k))[None, :, None] \
        + (2 * np.cos(k))[None, None, :]
    disp = np.array([[0, 0, 0], [1, 2, 3], [4, 0, L // 2], [3, 3, 1]])
    for deriv, power in ((False, 1), (True, 2)):
        want = [np.mean(np.cos(k[:, None, None] * dx) * np.cos(k[None, :, None] * dy)
                        * np.cos(k[None, None, :] * dz) / (e - eps) ** power)
                for dx, dy, dz in disp]
        got = g.at(e, disp, deriv)
        assert np.allclose(-got if deriv else got, want, rtol=1e-12, atol=1e-15)
    table = g.table(e)
    for dx, dy, dz in disp:
        assert table[dz, dx, dy] == pytest.approx(g.at(e, np.array([[dx, dy, dz]]))[0],
                                                  rel=1e-12)


@pytest.mark.parametrize("instance,gauge", [(0, None), (4, 2**31 + 1), (9, 6)])
def test_reference_agrees_with_dense_eigh(instance, gauge):
    a = lattice(12, instance, gauge)
    ref = REF.top_pairs(a, 10)
    w, U = np.linalg.eigh(a.toarray())
    w, U = w[::-1], U[:, ::-1]
    assert np.max(np.abs(ref.levels - w[:16])) <= 1e-13 * w[0]
    assert ref.tau == pytest.approx(w[10], abs=1e-9) and np.max(ref.resid) < 1e-9
    for j in range(10):
        assert abs(U[ref.rows, j] @ ref.vecs[:, j]) > 1 - 1e-13
    assert np.array_equal(REF.keep_rows(a.astype(np.float32)), ref.rows)


def test_kept_rows_hold_all_but_the_cut_of_each_vector():
    """At L = 64 the cubes leave rows out; the vectors on every row (from
    the whole Green's table) have unit norm, are eigenvectors of the
    matrix, and hold less than CUT of their norm off the kept rows."""
    a = lattice(64, 2, gauge=3)
    ref = REF.top_pairs(a, 10)
    assert ref.rows.size < a.shape[0]
    (_, s), lv = REF._solve(a)
    every = np.arange(a.shape[0])
    for j in (0, 9):
        v = REF._Level(lv, j).on(every)
        assert np.sum(v ** 2) == pytest.approx(1.0, abs=1e-12)
        off = np.ones(a.shape[0], bool)
        off[ref.rows] = False
        assert np.sqrt(np.sum(v[off] ** 2)) <= REF.CUT
        resid = a @ (v * s) - ref.theta[j] * v * s
        assert np.linalg.norm(resid) < 1e-12


def test_instances_place_the_same_levels_differently():
    """Two instances: levels alike to 1e-10 at L = 36, impurities elsewhere;
    a gauge moves only the vectors' signs."""
    ra, rb = REF.top_pairs(lattice(36, 1), 10), REF.top_pairs(lattice(36, 2), 10)
    assert np.max(np.abs(ra.theta - rb.theta)) < 1e-10
    assert set(REF._model(lattice(36, 1))[3]) != set(REF._model(lattice(36, 2))[3])
    g = REF.top_pairs(lattice(36, 1, gauge=7), 10)
    assert np.array_equal(g.theta, ra.theta) and np.array_equal(g.rows, ra.rows)
    assert np.allclose(np.abs(g.vecs), np.abs(ra.vecs), atol=1e-15)
    assert np.any(np.sign(g.vecs) != np.sign(ra.vecs))


def test_judge_reads_each_fault():
    a = lattice(12, 5, gauge=3)
    ref = REF.top_pairs(a, 10)
    kept, eigs, out = -ref.vecs.copy(), ref.theta.copy(), np.zeros(10)
    assert REF.judge(ref, eigs[::-1], kept[:, ::-1], out) == {"eig_err": 0.0, "vec_err": 0.0}
    e2 = eigs.copy()
    e2[3] += 1e-6 * eigs[0]
    assert REF.judge(ref, e2, kept, out)["eig_err"] == pytest.approx(1e-6)
    o2 = out.copy()
    o2[5] = 1e-8  # a vector with 1e-4 of its norm off the kept rows
    assert REF.judge(ref, eigs, kept, o2)["vec_err"] == pytest.approx(1e-4)
    bad = REF.judge(ref, eigs[:5], kept[:, :5], out[:5])
    assert bad == {"eig_err": np.inf, "vec_err": np.inf}
    k3 = kept.copy()
    k3[0, 0] = np.nan
    assert REF.judge(ref, eigs, k3, out)["vec_err"] == np.inf
    assert REF.judge(ref, eigs, None, None)["eig_err"] == np.inf


def test_no_certificate_off_the_model():
    a = lattice(12).tolil()
    missing = a.copy()
    missing[0, 1] = missing[1, 0] = 0.0
    bare = sp.csr_matrix(lattice(12) - sp.diags(lattice(12).diagonal()))
    for bad in (sp.csr_matrix(missing), bare, sp.csr_matrix(a[:1000, :1000])):
        bad.eliminate_zeros()
        with pytest.raises(ValueError, match="certificate"):
            REF.top_pairs(bad, 10)
    with pytest.raises(ValueError, match="certificate"):
        REF.top_pairs(lattice(12), 11)  # more than the kept levels


def test_control_reads_its_lower_precisions():
    a = lattice(12, 7, gauge=8)
    ref = REF.top_pairs(a, 10)
    for prec, eig_floor, vec_floor in (("float32", 1e-9, 1e-8), ("tf32", 1e-5, 1e-5)):
        eigs, V, rows = REF.control_answer(a, 10, prec, prec)
        assert np.array_equal(rows, ref.rows) and V.dtype == np.float32
        got = REF.judge(ref, eigs, V, np.zeros(10))
        assert eig_floor < got["eig_err"] < 100 * eig_floor
        assert vec_floor < got["vec_err"] < 100 * vec_floor


def test_tf32_rounding():
    x = np.array([1.0, 95.0 + 5.0 / 9.0, 97.2222222, -3.0e-3], np.float32)
    got = REF.tf32_round(x)
    assert got[0] == 1.0 and got[1] == 95.5625 and got[2] == 97.25
    assert abs(got[3] - x[3]) <= 2.0**-11 * abs(x[3])
