"""PyTorch port: the f64 operator of the polish (``solvers.polish.f64_operator``).

Each branch that builds it (``device_upcast``, ``raw_dia``, ``host_csr``)
is held to the build it replaced, scipy's DIA conversion of the raw matrix
in f64 (kept here as the oracle): the same offsets and the same planes, bit
for bit.  The branch is read from ``POLISH_PREP``, and ``solve_auto`` is
shown to polish a DIA route without calling ``scipy.sparse.dia_matrix``."""

import contextlib

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from ca_lanczos_tpu_torch.config import LanczosConfig
from ca_lanczos_tpu_torch.harness import auto
from ca_lanczos_tpu_torch.ops.formats import make_operator, negate_operator
from ca_lanczos_tpu_torch.solvers import polish as polish_mod

N = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dia_rows(d) -> np.ndarray:
    """scipy dia_matrix data -> DiaMatrix row convention
    (A[i, i+k] = data[row_of_k, i]; scipy stores A[i, i+k] at
    data[row_of_k, i+k])."""
    n = d.shape[0]
    out = np.zeros((len(d.offsets), n), np.float64)
    for j, k in enumerate(d.offsets):
        if k >= 0:
            out[j, : n - k] = d.data[j, k:n]
        else:
            out[j, -k:] = d.data[j, : n + k]
    return out


def _old_build(raw, which):
    """The polish's f64 planes as scipy's DIA conversion built them."""
    d = sp.dia_matrix(sp.csr_matrix(raw).astype(np.float64))
    sgn = -1.0 if which == "smallest" else 1.0
    return tuple(int(o) for o in d.offsets), torch.from_numpy(sgn * _dia_rows(d))


def _banded(offsets, dtype=np.float32, seed=0):
    """Symmetric matrix with random values on ``offsets`` (given >= 0)."""
    rng = np.random.default_rng(seed)
    diags, offs = [], []
    for k in offsets:
        v = rng.standard_normal(N - k)
        diags += [v] if k == 0 else [v, v]
        offs += [k] if k == 0 else [k, -k]
    return sp.diags(diags, offs, format="csr").astype(dtype)


def _with_duplicates(a, fmt):
    """``a`` with 40 diagonal entries stored twice: a COO, or a CSR whose
    rows keep both copies (not canonical)."""
    coo = a.tocoo()
    extra = np.arange(40)
    row = np.concatenate([coo.row, extra])
    col = np.concatenate([coo.col, extra])
    data = np.concatenate([coo.data, np.float32(1e-3) * np.arange(1, 41, dtype=np.float32)])
    if fmt == "coo":
        return sp.coo_matrix((data, (row, col)), shape=a.shape)
    order = np.lexsort((col, row))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=N))])
    out = sp.csr_matrix((data[order], col[order], indptr), shape=a.shape)
    assert not out.has_canonical_format and out.nnz == coo.nnz + 40
    return out


def _stored_zero():
    """A diagonal (+-7) that holds only explicitly stored zeros."""
    coo = _banded([0, 1]).tocoo()
    a = sp.csr_matrix((np.concatenate([coo.data, np.zeros(2, np.float32)]),
                       (np.concatenate([coo.row, [3, 10]]), np.concatenate([coo.col, [10, 3]]))),
                      shape=coo.shape)
    assert a.nnz == coo.nnz + 2
    return a


RAW = {
    "f32": lambda: _banded([0, 1, 3]),
    "f64": lambda: _banded([0, 1, 3], np.float64),
    "i64": lambda: sp.diags([np.full(N - 1, 2), np.arange(N) % 7, np.full(N - 1, 2)],
                            [-1, 0, 1], format="csr", dtype=np.int64),
    "stored_zero": _stored_zero,
    "coo_duplicates": lambda: _with_duplicates(_banded([0, 1]), "coo"),
    "csr_duplicates": lambda: _with_duplicates(_banded([0, 1]), "csr"),
    "diags48": lambda: _banded(range(1, 25)),
    "diags49": lambda: _banded(range(0, 25)),
}

# (raw, solve operator, expected branch); "none": no solve operator (the
# distributed solve), "ilv": a permuted route
CASES = [
    ("f32", "dia", "device_upcast"),
    ("f64", "dia", "device_upcast"),
    ("i64", "dia", "raw_dia"),  # int64 does not cast safely to f32 planes
    ("stored_zero", "dia", "device_upcast"),
    ("coo_duplicates", "dia", "raw_dia"),
    ("csr_duplicates", "dia", "raw_dia"),
    ("f32", "none", "raw_dia"),
    ("diags48", "dia", "device_upcast"),
    ("diags49", "dia", "host_csr"),
    ("f32", "ilv", "host_csr"),
]


@pytest.fixture
def captured(monkeypatch):
    """Replace both polishes (and the host SpMM) by recorders of the
    operator they are given."""
    got = {}

    def device_polish(A64, X, iters, depth):
        got["A64"] = A64
        k = X.shape[1]
        return np.zeros(k), np.zeros(k), torch.as_tensor(X)

    def host_polish(matvec, X, iters, depth):
        got["matvec"] = matvec
        k = X.shape[1]
        return np.zeros(k), np.zeros(k), np.asarray(X)

    class Csr:
        def __init__(self, m):
            got["csr"] = m

        def __call__(self, Z):
            return got["csr"] @ Z

    monkeypatch.setattr(polish_mod, "rayleigh_ritz_polish", device_polish)
    monkeypatch.setattr(polish_mod, "rayleigh_ritz_polish_host", host_polish)
    monkeypatch.setattr("ca_lanczos_tpu_torch.ops._spmm_native.CsrMatmul", Csr)
    return got


@pytest.mark.parametrize("which", ["largest", "smallest"])
@pytest.mark.parametrize("raw_name,solve_op,branch", CASES)
def test_polish_operator_is_the_old_build(captured, raw_name, solve_op, branch, which):
    raw = RAW[raw_name]()
    oracle = _old_build(raw, which)
    A = route = None
    if solve_op != "none":
        # on a copy: the route sums a non-canonical CSR's duplicates in place
        A, route = make_operator(raw.copy(), prefer=solve_op, device="cpu")
        if which == "smallest":
            A = negate_operator(A)
    Q = torch.as_tensor(np.linalg.qr(np.random.default_rng(1).standard_normal((N, 3)))[0])
    before = dict(polish_mod.POLISH_PREP)
    polish_mod.f64_operator(raw, A, route, which, device="cpu")[0](Q, 2, 2)
    assert {k: polish_mod.POLISH_PREP[k] - before[k] for k in before} == {
        k: int(k == branch) for k in before}
    if branch == "host_csr":
        assert "A64" not in captured
        csr = captured["csr"]
        assert csr.dtype == np.float64 and (csr != sp.csr_matrix(raw).astype(np.float64)).nnz == 0
        x = np.random.default_rng(2).standard_normal((N, 2))
        sgn = -1.0 if which == "smallest" else 1.0
        np.testing.assert_array_equal(captured["matvec"](x), sgn * (csr @ x))
        return
    A64 = captured["A64"]
    assert A64.data.dtype == torch.float64
    assert A64.offsets == oracle[0]
    assert torch.equal(A64.data, oracle[1])


def test_the_route_sums_a_noncanonical_csr_in_place():
    """Why the upcast may take a CSR whose duplicates the route summed:
    ``make_operator`` sums them in the caller's arrays (scipy shares them),
    so by the polish the raw matrix holds the route's f32 sums, and the old
    build of it equals the upcast planes."""
    raw = RAW["csr_duplicates"]()
    A, route = make_operator(raw, prefer="dia", device="cpu")
    assert raw.nnz == route.nnz and polish_mod._planes_hold_raw(raw, A, route)
    offsets, planes = _old_build(raw, "largest")
    assert A.offsets == offsets and torch.equal(A.data.double(), planes)


def test_solve_auto_polishes_on_the_solve_planes(monkeypatch):
    """One ``solve_auto`` with a polish on an f32 DIA route: one
    ``device_upcast``, no host build, no call of scipy's DIA conversion,
    and the branch's name on the ``polish.prep`` span."""
    def refuse(*a, **k):
        raise AssertionError("scipy.sparse.dia_matrix called")

    named = []

    def span(name, args=None):
        named.append((name, args))
        return contextlib.nullcontext()

    monkeypatch.setattr(sp, "dia_matrix", refuse)
    monkeypatch.setattr(polish_mod, "span", span)
    n = 4096  # tests/test_torch_auto.py's two-stage operator, in f32
    d = np.linspace(1.0, 90.0, n)
    d[-5:] = np.linspace(95.0, 100.0, 5)
    off = np.random.default_rng(0).standard_normal(n - 1) * 1e-3
    a = sp.diags([off, d, off], [-1, 0, 1], format="csr").astype(np.float32)
    before = dict(polish_mod.POLISH_PREP)
    res = auto.solve_auto(a, np.random.default_rng(1).standard_normal(n), 32,
                          LanczosConfig(n_wanted=5, s=8, tol=1e-4, max_restarts=100),
                          engine="fused", polish=2, over_lock=3, prefer="dia", device="cpu")
    assert {k: polish_mod.POLISH_PREP[k] - before[k] for k in before} == {
        "device_upcast": 1, "raw_dia": 0, "host_csr": 0}
    assert ("polish.prep", "device_upcast") in named
    assert [n for n, _ in named].count("polish.prep") == 1
    a64 = a.astype(np.float64)
    exact = sla.eigh_tridiagonal(a64.diagonal(0), a64.diagonal(1), eigvals_only=True)
    assert res.converged
    np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact[::-1][:5], rtol=1e-10)


def _dia_cases():
    band = _banded((0, 1, 5))
    messy = sp.coo_matrix(band)
    messy = sp.csr_matrix((np.concatenate([messy.data, [0.5, -0.25]]),
                           (np.concatenate([messy.row, [3, 3]]),
                            np.concatenate([messy.col, [8, 8]]))), shape=band.shape)
    zeros = band.copy()
    zeros.data[zeros.indices == 7] = 0.0  # stored zeros: column 7 of every row
    return {"band_f32": band, "band_f64": band.astype(np.float64), "duplicates": messy,
            "stored_zero": zeros, "empty": sp.csr_matrix((N, N), dtype=np.float32),
            "wide": _banded(tuple(range(0, 30)))}


def _numpy_dia(a, max_diags, waste_cap, dtype):
    """The host build ``dia_from_scipy`` had before it built on its device
    (numpy, O(nnz log nnz)): the oracle.  (offsets, planes) or None."""
    csr = sp.csr_matrix(a)
    csr.sum_duplicates()
    coo = csr.tocoo()
    n = coo.shape[0]
    if dtype is None:
        dtype = np.float64 if coo.data.dtype == np.float64 else np.float32
    if coo.nnz == 0:
        return (0,), np.zeros((1, n), dtype)
    offs_e = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offsets = np.unique(offs_e)
    if len(offsets) > max_diags or len(offsets) * n > waste_cap * coo.nnz:
        return None
    data = np.zeros((len(offsets), n), dtype)
    data[np.searchsorted(offsets, offs_e), coo.row] = coo.data.astype(dtype)
    return tuple(int(d) for d in offsets), data


@pytest.mark.parametrize("name", list(_dia_cases()))
@pytest.mark.parametrize("dtype", [None, np.float64])
def test_dia_on_device_is_dia_from_scipy(name, dtype):
    """The planes ``dia_from_scipy`` builds on its device (the polish's
    ``raw_dia`` branch, the routes on the host) are the old numpy
    build's, bit for bit, and refused under the same limits."""
    from ca_lanczos_tpu_torch.ops.formats import dia_from_scipy

    a = _dia_cases()[name]
    for max_diags, cap in ((64, np.inf), (16, np.inf), (64, 8.0)):
        want = _numpy_dia(a.copy(), max_diags, cap, dtype)
        got = dia_from_scipy(a.copy(), max_diags=max_diags, waste_cap=cap, dtype=dtype,
                             device="cpu")
        assert (got is None) == (want is None)
        if want is not None:
            assert got.offsets == want[0]
            assert torch.equal(got.data, torch.from_numpy(want[1]))
