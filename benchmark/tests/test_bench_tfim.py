"""The transverse-field Ising chain's recipe against a Kronecker-product
build, its free-fermion reference against dense eigvalsh, its certificate
and its judge."""

from functools import reduce
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
REF = harness.load_module(BENCH / "reference" / "tfim_free_fermion.py")
RECIPE = harness.load_module(BENCH / "matrices" / "tfim_chain.py")
LIMITS = harness.load_json(BENCH / "limits" / "tfim-chain22.polish10.json")
X = sp.csr_matrix([[0.0, 1.0], [1.0, 0.0]])
Z = sp.csr_matrix([[1.0, 0.0], [0.0, -1.0]])


def site(op, i, L):
    """``op`` on spin i (1..L), spin i on bit i - 1 of the row index."""
    eye = sp.identity(2, format="csr")
    return reduce(lambda a, b: sp.kron(a, b, format="csr"),
                  [op if L - k == i else eye for k in range(L)])


def kron_build(L, J, h, b):
    a = b * site(Z, 1, L)
    for i in range(1, L):
        a = a + J * site(Z, i, L) @ site(Z, i + 1, L)
    for i in range(1, L + 1):
        a = a + h * site(X, i, L)
    return a.toarray()


def chain(L, gauge=None, J=1.0, h=2.5, b=1.0):
    a = RECIPE.build(1 << L, 0, J, h, b)
    if gauge is not None:  # S A S as the harness makes it, stored zeros kept
        s = harness.signature(1 << L, gauge)
        a.data *= s[np.repeat(np.arange(1 << L), L + 1)] * s[a.indices]
    return a


def test_recipe_equals_the_kronecker_build():
    L = 8
    a = RECIPE.build(1 << L, 0, 1.0, 2.5, 1.0)
    assert a.has_sorted_indices and a.nnz == (L + 1) << L
    assert np.array_equal(np.diff(a.indptr), np.full(1 << L, L + 1))
    assert np.array_equal(a.toarray(), kron_build(L, 1.0, 2.5, 1.0))
    assert np.count_nonzero(a.diagonal() == 0) > 0  # stored zeros
    with pytest.raises(ValueError, match="2\\^L"):
        RECIPE.build(3 << 6, 0, 1.0, 2.5, 1.0)


@pytest.mark.parametrize("L", [9, 10])
@pytest.mark.parametrize("h", [2.5, 1.3])
@pytest.mark.parametrize("b", [0.0, 1.0])
def test_free_fermion_levels_equal_eigvalsh(L, h, b):
    w = np.linalg.eigvalsh(chain(L, h=h, b=b).toarray())[::-1]
    lv, above = REF.levels(L, 1.0, h, b, max_qp=L)
    assert above == -np.inf and lv.size == 1 << L
    assert np.max(np.abs(lv - w)) <= 1e-12 * w[0]


def test_reference_certifies_the_top_in_any_gauge():
    L = 12
    a = chain(L, gauge=2**31 + 5).astype(np.float32)
    ref = REF.top_pairs(a, 10)
    w = scipy.linalg.eigvalsh(a.toarray().astype(np.float64))[::-1]
    assert np.max(np.abs(ref.theta - w[:10])) <= 1e-12 * w[0]
    m = ref.levels.size
    assert m >= 13 and np.max(np.abs(ref.levels - w[:m])) <= 1e-12 * w[0]
    assert ref.tau >= w[m] and ref.tau < w[m - 1]
    assert np.array_equal(REF.keep_rows(a), np.arange(1 << L))


def exact_answer(a, k=10):
    w, U = scipy.linalg.eigh(a.toarray().astype(np.float64))
    return w[::-1][:k].copy(), U[:, ::-1][:, :k].astype(np.float32).astype(np.float64)


def test_judge_reads_each_fault():
    a = chain(11, gauge=3).astype(np.float32)
    ref = REF.top_pairs(a, 10)
    eigs, U = exact_answer(a)
    out = np.zeros(10)
    ok = REF.judge(ref, eigs[::-1], -U[:, ::-1], out)  # any order, any sign
    assert ok["eig_err"] <= 1e-14 and ok["vec_err"] < 1e-4 < LIMITS["vec_err"]
    # shift_eig: the first value off by 1e-3 of itself
    e2 = eigs.copy()
    e2[0] *= 1 + 1e-3
    assert REF.judge(ref, e2, U, out)["eig_err"] > LIMITS["eig_err"]
    # alter_vector: one entry of the first vector moved by 1e-2
    U2 = U.copy()
    U2[int(np.abs(U2[:, 0]).argmax()), 0] += 1e-2
    assert REF.judge(ref, eigs, U2, out)["vec_err"] > LIMITS["vec_err"]
    # half_the_pairs
    assert REF.judge(ref, eigs[:5], U[:, :5], out[:5]) == {"eig_err": np.inf,
                                                           "vec_err": np.inf}
    # unpolished: vectors to the solve's tolerance, values their Rayleigh quotients
    rng = np.random.default_rng(0)
    U3 = U + 1e-4 * rng.standard_normal(U.shape)
    U3 /= np.linalg.norm(U3, axis=0)
    rq = np.sum(U3 * (a.astype(np.float64) @ U3), axis=0)
    got = REF.judge(ref, rq, U3, out)
    assert got["vec_err"] > LIMITS["vec_err"] and got["eig_err"] > LIMITS["eig_err"]
    # a non-finite entry, rows kept outside, or no rows at all
    U4 = U.copy()
    U4[0, 0] = np.nan
    assert REF.judge(ref, eigs, U4, out)["vec_err"] == np.inf
    assert REF.judge(ref, eigs, U, np.full(10, 1e-8))["vec_err"] == np.inf
    assert REF.judge(ref, eigs, None, None)["eig_err"] == np.inf


def test_no_certificate_off_the_model():
    a = chain(10, gauge=7).tolil()
    hop = a.copy()
    hop[5, 5 ^ 8] = hop[5 ^ 8, 5] = 2.0 * np.sign(hop[5, 5 ^ 8])  # not one |h|
    flip = a.copy()
    flip[5, 5 ^ 8] = -flip[5, 5 ^ 8]  # not symmetric, so not a gauge
    diag = a.copy()
    diag[9, 9] += 1.0  # not J ZZ + b Z_1
    far = chain(10).tolil()
    far[3, 3 ^ 5] = far[3 ^ 5, 3] = 2.5  # a two-spin flip
    for bad in (hop, flip, diag, far):
        with pytest.raises(ValueError, match="certificate"):
            REF.top_pairs(bad.tocsr(), 10)
    with pytest.raises(ValueError, match="certificate"):  # 8 levels, 13 needed
        REF.top_pairs(chain(3), 10)


def test_control_reads_its_lower_precisions():
    a = chain(12, gauge=8).astype(np.float32)
    ref = REF.top_pairs(a, 10)
    f32 = REF.judge(ref, *REF.control_answer(a, 10, "float32", "float32")[:2], np.zeros(10))
    tf32 = REF.judge(ref, *REF.control_answer(a, 10, "float32", "tf32")[:2], np.zeros(10))
    assert 1e-9 < f32["eig_err"] < 1e-7 and f32["vec_err"] < 1e-4
    assert tf32["vec_err"] > 100 * f32["vec_err"] and tf32["vec_err"] > LIMITS["vec_err"]
