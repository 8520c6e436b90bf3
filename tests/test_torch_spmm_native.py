"""PyTorch port, ops/_spmm_native.py (the host polish's row-parallel CSR
SpMM) against scipy's ``a @ X`` and the JAX package's ``CsrMatmul``, and
``solvers.polish.f64_operator``'s host branch against JAX's ``_polish_block``.

Tolerances: the products are exact.  Each entry is summed over its row's
entries in their stored order, as scipy does, with no fused multiply-add,
so the port equals scipy's ``a @ X`` bit for bit on any index order, and
JAX's ``CsrMatmul`` (which sorts the indices first; scipy above 64
columns) bit for bit on the sorted matrix.  The polish: eigenvalues rtol
1e-10 against JAX and the exact values (as
tests/test_torch_auto.py::test_permuted_route_polishes_on_host), kept-set
residuals within 1e-10 of the spectral radius of JAX's."""

import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ca_lanczos_tpu.harness.auto import _polish_block as j_polish_block
from ca_lanczos_tpu.ops import _spmm_native as jspmm
from ca_lanczos_tpu_torch.ops import _spmm_native as spmm
from ca_lanczos_tpu_torch.solvers.polish import f64_operator

N = 3000
KS = [None, 1, 13, 64, 65, 130]  # None: a vector of shape (n,)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the SpMM's thread count too): several pytest
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unsorted_csr(n=N, seed=0):
    """0 to 12 entries a row in random column order (repeats included),
    about one row in 8 empty."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 13, n) * (rng.random(n) > 0.125)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    a = sp.csr_matrix((rng.standard_normal(indptr[-1]), rng.integers(0, n, indptr[-1]),
                       indptr), (n, n))
    assert not a.has_sorted_indices and (np.diff(a.indptr) == 0).any()
    return a


A_UNSORTED = _unsorted_csr()
A_SORTED = A_UNSORTED.sorted_indices()


def _x(k, seed=1):
    return np.random.default_rng(seed).standard_normal(N if k is None else (N, k))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("layout", ["unsorted", "sorted"])
def test_equals_scipy_and_jax(layout, k):
    a = A_UNSORTED if layout == "unsorted" else A_SORTED
    X = _x(k)
    before = spmm.APPLIES["csr_spmm_host"]
    Y = spmm.CsrMatmul(a)(X)
    assert spmm.APPLIES["csr_spmm_host"] == before + 1
    assert Y.shape == X.shape and Y.dtype == np.float64
    np.testing.assert_array_equal(Y, a @ X)
    # JAX sorts the indices of its copy, then sums in that order
    np.testing.assert_array_equal(spmm.CsrMatmul(A_SORTED)(X),
                                  jspmm.CsrMatmul(a.copy())(X))
    assert a.has_sorted_indices == (layout == "sorted")  # the caller's matrix is untouched


def test_threads_and_inputs():
    """Every column on several threads; f32 matrices and X, non-contiguous
    X and other sparse formats are taken as scipy takes them."""
    X = _x(130, seed=2)
    want = A_UNSORTED @ X
    torch.set_num_threads(3)
    try:
        got = spmm.CsrMatmul(A_UNSORTED)(X)
    finally:
        torch.set_num_threads(1)
    np.testing.assert_array_equal(got, want)
    a32 = A_SORTED.astype(np.float32)
    Xf = np.asfortranarray(X[:, ::2]).astype(np.float32)
    np.testing.assert_array_equal(spmm.CsrMatmul(a32)(Xf),
                                  a32.astype(np.float64) @ Xf.astype(np.float64))
    coo = A_SORTED.tocoo()  # to CSR again, its repeated entries summed first
    np.testing.assert_array_equal(spmm.CsrMatmul(coo)(X), sp.csr_matrix(coo) @ X)
    with pytest.raises(ValueError, match="shape"):
        spmm.CsrMatmul(A_SORTED)(X[:-1])
    with pytest.raises(TypeError, match="real"):
        spmm.CsrMatmul(A_SORTED)(X + 1j)


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    """No fallback: the compiler's error reaches the caller."""
    bad = tmp_path / "host_spmm.cpp"
    bad.write_text("extern \"C\" void csr_spmm_f64( {\n")
    monkeypatch.setattr(spmm, "SOURCE", bad)
    monkeypatch.setattr(spmm, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ .*failed:\n.*error"):
        spmm.CsrMatmul(A_SORTED)
    assert not spmm.available()


def test_importing_the_module_builds_nothing():
    code = ("import ca_lanczos_tpu_torch, ca_lanczos_tpu_torch.harness.auto\n"
            "from ca_lanczos_tpu_torch.ops import _spmm_native as m\n"
            "assert m._LIB is None and m.APPLIES['csr_spmm_host'] == 0\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def _bottom_separated(n, seed, offdiag):
    """A symmetric matrix whose 13 smallest eigenvalues (about -100 ... -94)
    stand apart from the rest (1 ... 90): ``offdiag`` gives the couplings."""
    d = np.linspace(1.0, 90.0, n)
    d[:13] = np.linspace(-100.0, -94.0, 13)
    off = offdiag(np.random.default_rng(seed))
    return (off + off.T + sp.diags(d)).tocsr()


def _permuted(n=2000, seed=3):
    """A tridiagonal, randomly permuted: the route's permutation sends the
    polish to the host."""
    def off(rng):
        return sp.diags(rng.standard_normal(n - 1) * 1e-3, 1)
    a = _bottom_separated(n, seed, off)
    p = np.random.default_rng(seed + 1).permutation(n)
    return a[p][:, p].tocsr(), types.SimpleNamespace(perm=p)


def _general(n=2000, seed=4):
    """Random couplings inside a band of half-width 100: more than 48
    diagonals, so the polish takes the host branch with no route."""
    def off(rng):
        rows = np.repeat(np.arange(n), 3)
        cols = np.clip(rows + rng.integers(-100, 101, rows.size), 0, n - 1)
        return sp.csr_matrix((rng.standard_normal(rows.size) * 1e-2, (rows, cols)), (n, n))
    return _bottom_separated(n, seed, off), None


@pytest.mark.parametrize("case", ["permuted", "general"])
def test_polish_host_branch_smallest_matches_jax(case):
    """``which="smallest"``: the host branch polishes -A through the native
    SpMM, 13 columns (a depth-4 panel of 65), and returns JAX's values."""
    raw, route = _permuted() if case == "permuted" else _general()
    if route is None:
        coo = raw.tocoo()
        assert len(np.unique(coo.col - coo.row)) > 48
    k, iters, depth = 13, 3, 4
    evals, evecs = np.linalg.eigh(raw.toarray())
    Q0 = evecs[:, :k] + 1e-3 * np.random.default_rng(5).standard_normal((raw.shape[0], k))
    before = spmm.APPLIES["csr_spmm_host"]
    w, resid, Q = f64_operator(raw, None, route, "smallest",
                               device="cpu")[0](torch.as_tensor(Q0), iters, depth)
    assert spmm.APPLIES["csr_spmm_host"] == before + 1 + iters * (depth + 1)
    wj, rj, Qj = j_polish_block(raw, None, route, Q0, "smallest", iters, depth)
    scale = float(np.abs(evals).max())
    assert Q.shape == (raw.shape[0], k) and isinstance(Q, torch.Tensor)
    np.testing.assert_allclose(w, wj, rtol=1e-10)
    np.testing.assert_allclose(w, -evals[:k], rtol=1e-10)  # desc in the solve frame (-A)
    np.testing.assert_allclose(resid, rj, rtol=0, atol=1e-10 * scale)
    assert float(np.max(resid)) <= 1e-10 * scale
    Qn = Q.numpy()
    np.testing.assert_allclose(np.abs(np.sum(Qn * np.asarray(Qj), axis=0)), 1.0, atol=1e-8)
