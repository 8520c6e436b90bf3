"""PyTorch port, utils/mmio.py and utils/reorder.py against the JAX
package (``device="cpu"``, float64); mirrors
tests/test_harness.py::TestMmio and ::TestRcmReorder.

Tolerances: the parsed COO arrays, the permutation, the bandwidths, the
DIA offsets and planes and the written .mtx text are exact (the same
numpy/scipy calls or the same formatting); an ELL operator and the
reordered operators' ``to_dense`` equal JAX's to 1e-15.  Eigenvalues of a
solve on the reordered operator: rtol 1e-7 against the dense oracle, as
the JAX test."""

import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ca_lanczos_tpu.ops.spmv import DiaMatrix as JDia
from ca_lanczos_tpu.ops.spmv import EllMatrix as JEll
from ca_lanczos_tpu.utils import mmio as jmmio
from ca_lanczos_tpu.utils.reorder import rcm_reorder as jrcm
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, EllMatrix
from ca_lanczos_tpu_torch.utils import mmio
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy
from ca_lanczos_tpu_torch.utils.reorder import rcm_reorder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_coo(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]


def _random_general(tmp_path):
    rng = np.random.default_rng(0)
    a = sp.random(50, 50, density=0.1, random_state=rng.integers(1 << 30))
    return a + a.T  # symmetric values, stored general


# Hand-written files: every header kind both parsers take, with comments.
_FILES = {
    "general": "%%MatrixMarket matrix coordinate real general\n% c\n3 3 4\n"
               "1 1 2.5\n3 1 -1e-3\n2 2 4\n1 3 7\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n% a\n% b\n3 3 4\n"
                 "1 1 2\n2 1 1\n3 2 0.5\n3 3 4\n",
    "skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n3 3 2\n2 1 1.5\n3 1 -2\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern symmetric\n4 4 3\n1 1\n3 1\n4 2\n",
}


@pytest.mark.parametrize("kind", sorted(_FILES))
def test_load_mtx_matches_jax(tmp_path, kind):
    """Native parser and Python parser each give JAX's arrays, and the
    two parsers agree (symmetric and skew storage expanded)."""
    path = str(tmp_path / f"{kind}.mtx")
    with open(path, "w") as f:
        f.write(_FILES[kind])
    assert mmio.native_available()
    got = mmio.load_mtx(path)
    _same_coo(got, jmmio.load_mtx(path))
    _same_coo(mmio._load_mtx_python(path), jmmio._load_mtx_python(path))
    _same_coo(got, mmio._load_mtx_python(path))


# Files the port refuses: the JAX package reads each as a real matrix (the
# 2 x 2 Hermitian one as the entries (1,1) = 2 and (2,1) = 1, unmirrored).
_REFUSED = {
    "complex_hermitian": "%%MatrixMarket matrix coordinate complex hermitian\n2 2 2\n"
                         "1 1 2 0\n2 1 1 2\n",
    "complex_general": "%%MatrixMarket matrix coordinate complex general\n% c\n2 2 1\n"
                       "1 2 1 -1\n",
    "real_hermitian": "%%MatrixMarket matrix coordinate real hermitian\n2 2 2\n1 1 2\n2 1 1\n",
}


@pytest.mark.parametrize("kind", sorted(_REFUSED))
@pytest.mark.parametrize("native", [True, False])
def test_load_mtx_refuses_complex_and_hermitian(tmp_path, monkeypatch, kind, native):
    """A divergence from the JAX package: ``load_mtx`` raises ValueError
    before either parser runs."""
    path = str(tmp_path / f"{kind}.mtx")
    with open(path, "w") as f:
        f.write(_REFUSED[kind])
    if not native:
        monkeypatch.setattr(mmio, "_load_lib", lambda: None)
    with pytest.raises(ValueError, match="complex and Hermitian"):
        mmio.load_mtx(path)
    with pytest.raises(ValueError, match="complex and Hermitian"):
        mmio.load_operator(path, device="cpu")
    if kind == "complex_hermitian":
        ri, ci, vi, shape = jmmio.load_mtx(path)
        assert (ri.tolist(), ci.tolist(), vi.tolist(), shape) == ([0, 1], [0, 0], [2.0, 1.0],
                                                                  (2, 2))


def test_roundtrip_and_native_matches_python(tmp_path):
    a = _random_general(tmp_path)
    path = str(tmp_path / "t.mtx")
    mmio.save_mtx(path, a)
    ri, ci, vi, shape = mmio.load_mtx(path)
    got = sp.coo_matrix((vi, (ri, ci)), shape=shape).toarray()
    np.testing.assert_allclose(got, a.toarray(), atol=1e-15)
    _same_coo(mmio.load_mtx(path), mmio._load_mtx_python(path))


def test_symmetric_storage_expanded(tmp_path):
    a = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 0.5], [0.0, 0.5, 4.0]])
    path = str(tmp_path / "sym.mtx")
    mmio.save_mtx(path, sp.coo_matrix(a), symmetric=True)
    ri, ci, vi, shape = mmio.load_mtx(path)
    np.testing.assert_array_equal(sp.coo_matrix((vi, (ri, ci)), shape=shape).toarray(), a)


def test_fallback_warns_and_parses(tmp_path, monkeypatch):
    """No native library (or a file it cannot open): the Python parser
    runs, with a RuntimeWarning."""
    path = str(tmp_path / "g.mtx")
    with open(path, "w") as f:
        f.write(_FILES["general"])
    monkeypatch.setattr(mmio, "_load_lib", lambda: None)
    with pytest.warns(RuntimeWarning, match="pure-Python fallback"):
        got = mmio.load_mtx(path)
    _same_coo(got, jmmio._load_mtx_python(path))


@pytest.mark.parametrize("symmetric", [False, True])
def test_save_mtx_text_equals_jax(tmp_path, symmetric):
    """Byte for byte, across several chunks of the vectorised writer, with
    awkward values (signed zero, subnormal, huge, many digits)."""
    rng = np.random.default_rng(3)
    n = 3 * mmio._CHUNK // 2
    vals = rng.standard_normal(n)
    vals[:6] = [0.0, -0.0, 5e-324, 1e300, -1 / 3, 123456789.0]
    off = rng.standard_normal(n - 7) * 1e-3
    a = sp.coo_matrix(sp.diags([off, vals, off], [-7, 0, 7]))
    pt, pj = str(tmp_path / "t.mtx"), str(tmp_path / "j.mtx")
    mmio.save_mtx(pt, a, symmetric=symmetric)
    jmmio.save_mtx(pj, a, symmetric=symmetric)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    # a dense float32 input too (the JAX writer formats np.float32 values)
    d = np.asarray(rng.standard_normal((20, 20)), np.float32)
    mmio.save_mtx(pt, d, symmetric=symmetric)
    jmmio.save_mtx(pj, d, symmetric=symmetric)
    assert open(pt, "rb").read() == open(pj, "rb").read()


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_load_operator_formats_match_jax(tmp_path, dtype):
    """Banded -> DIA (same offsets, same planes), scattered -> ELL (same
    dense matrix)."""
    import jax.numpy as jnp

    tri = sp.diags([[-1.0] * 39, [2.0] * 40, [-1.5] * 39], [-1, 0, 2])
    p1 = str(tmp_path / "band.mtx")
    mmio.save_mtx(p1, tri)
    A = mmio.load_operator(p1, dtype=getattr(torch, dtype) if dtype else None, device="cpu")
    Aj = jmmio.load_operator(p1, dtype=getattr(jnp, dtype) if dtype else None)
    assert isinstance(A, DiaMatrix) and isinstance(Aj, JDia)
    assert A.offsets == Aj.offsets
    assert str(A.dtype).split(".")[-1] == str(Aj.data.dtype)
    np.testing.assert_array_equal(A.data.numpy(), np.asarray(Aj.data))
    scat = sp.random(60, 60, density=0.3, random_state=7)
    p2 = str(tmp_path / "scat.mtx")
    mmio.save_mtx(p2, scat)
    B = mmio.load_operator(p2, device="cpu")
    Bj = jmmio.load_operator(p2)
    assert isinstance(B, EllMatrix) and isinstance(Bj, JEll)
    np.testing.assert_allclose(B.to_dense().numpy(), np.asarray(Bj.to_dense()), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(B.to_dense().numpy(), scat.toarray(), rtol=0, atol=1e-15)


def test_importing_the_port_builds_nothing():
    """Importing the package and its utils touches no compiler: the
    parser library is built at first use."""
    code = ("import ca_lanczos_tpu_torch, ca_lanczos_tpu_torch.utils, "
            "ca_lanczos_tpu_torch.harness, ca_lanczos_tpu_torch.__main__\n"
            "from ca_lanczos_tpu_torch.utils import mmio\n"
            "assert mmio._LIB is None and not mmio._TRIED\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# --------------------------------------------------------------------------
# reorder
# --------------------------------------------------------------------------


def _scrambled_band(seed=0, n=120):
    rng = np.random.default_rng(seed)
    band = sp.diags(
        [rng.standard_normal(n - 2), rng.standard_normal(n) + 4, rng.standard_normal(n - 2)],
        [-2, 0, 2],
    ).tocsr()
    band = (band + band.T) / 2
    p = rng.permutation(n)
    return band, band[p][:, p]


def _same_reordering(ro, rj):
    np.testing.assert_array_equal(ro.perm, rj.perm)
    assert (ro.bandwidth_before, ro.bandwidth_after) == (rj.bandwidth_before, rj.bandwidth_after)
    assert type(ro.A).__name__ == type(rj.A).__name__
    if isinstance(ro.A, DiaMatrix):
        assert ro.A.offsets == rj.A.offsets
    np.testing.assert_allclose(ro.A.to_dense().numpy(), np.asarray(rj.A.to_dense()), rtol=0,
                               atol=1e-15)


def test_rcm_matches_jax_dia():
    band, scr = _scrambled_band()
    ro, rj = rcm_reorder(scr, device="cpu"), jrcm(scr)
    assert isinstance(ro.A, DiaMatrix) and ro.A.dtype == torch.float64
    assert ro.bandwidth_after < ro.bandwidth_before
    _same_reordering(ro, rj)
    d_orig = np.sort(np.linalg.eigvalsh(band.toarray()))
    d_reord = np.sort(np.linalg.eigvalsh(ro.A.to_dense().numpy()))
    np.testing.assert_allclose(d_reord, d_orig, atol=1e-10)


def test_rcm_matches_jax_ell_and_dense_input():
    """Past dia_max_diags the result is ELL; a dense array and a port
    operator as input (densified, as JAX does) give the same result."""
    a = sp.random(80, 80, density=0.08, random_state=3)
    a = (a + a.T + 10 * sp.eye(80)).tocsr()
    ro, rj = rcm_reorder(a, dia_max_diags=4, device="cpu"), jrcm(a, dia_max_diags=4)
    assert isinstance(ro.A, EllMatrix)
    _same_reordering(ro, rj)
    _same_reordering(rcm_reorder(a.toarray(), device="cpu"), jrcm(a.toarray()))
    Aj = JEll.from_scipy(a)
    _same_reordering(rcm_reorder(operator_from_numpy(Aj, device="cpu"), device="cpu"), jrcm(Aj))


def test_restore_roundtrip():
    rng = np.random.default_rng(1)
    a = sp.random(50, 50, density=0.1, random_state=3)
    a = a + a.T + 10 * sp.eye(50)
    ro = rcm_reorder(a, device="cpu")
    x = rng.standard_normal((50, 3))
    np.testing.assert_array_equal(ro.restore(ro.apply(x)), x)
    np.testing.assert_array_equal(ro.apply(x), jrcm(a).apply(x))
    t = torch.as_tensor(x)
    assert isinstance(ro.apply(t), torch.Tensor)
    np.testing.assert_array_equal(ro.apply(t).numpy(), ro.apply(x))
    np.testing.assert_array_equal(ro.restore(ro.apply(t)).numpy(), x)


def test_solver_on_reordered():
    """Scrambled banded SPD matrix -> RCM -> restarted driver on the DIA
    operator -> the dense oracle's eigenvalues."""
    from ca_lanczos_tpu_torch.config import Basis, LanczosConfig, Orth
    from ca_lanczos_tpu_torch.solvers.restarted import restarted_ca_lanczos

    rng = np.random.default_rng(2)
    n = 300
    band = sp.diags(
        [np.full(n - 1, -1.0), np.linspace(4, 40, n), np.full(n - 1, -1.0)], [-1, 0, 1]
    ).tocsr()
    p = rng.permutation(n)
    ro = rcm_reorder(band[p][:, p], device="cpu")
    assert isinstance(ro.A, DiaMatrix)
    cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=Orth.FULL, n_wanted=4, tol=1e-9)
    res = restarted_ca_lanczos(ro.A, torch.ones(n, dtype=torch.float64), 32, cfg)
    assert res.converged
    exact = np.sort(np.linalg.eigvalsh(band.toarray()))[::-1][:4]
    np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-7)
