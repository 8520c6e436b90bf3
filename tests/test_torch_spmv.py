"""PyTorch port, ops/spmv.py: matvecs and normest against the JAX package
on identical operators (built with numpy, carried across with
``operator_from_numpy``).  float64 on both sides; tolerance rtol 1e-12
(the products sum in the same order, so only last-bit differences
remain)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy

# the modules themselves (ca_lanczos_tpu.ops re-exports a function `spmv`)
jspmv = importlib.import_module("ca_lanczos_tpu.ops.spmv")
tspmv = importlib.import_module("ca_lanczos_tpu_torch.ops.spmv")

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _banded(n, offsets, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n))
    for d, k in enumerate(offsets):
        if k > 0:
            data[d, n - k:] = 0
        elif k < 0:
            data[d, :-k] = 0
    return jspmv.DiaMatrix(data=jnp.asarray(data), offsets=tuple(offsets))


def _sparse(n, seed=0):
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.01, random_state=rng, format="csr")
    return (a + a.T + sp.eye(n)).tocsr()


@pytest.mark.parametrize("offsets", [(-1, 0, 1), tuple(range(-4, 5)), (-3, 0, 2)])
@pytest.mark.parametrize("ncols", [0, 3])
def test_dia_matvec_matches_jax(offsets, ncols):
    n = 1000
    Aj = _banded(n, offsets)
    At = operator_from_numpy(Aj, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, ncols) if ncols else n)
    want = np.asarray(Aj.matvec(jnp.asarray(x)))
    got = At.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)


def test_dia_to_dense_and_from_dense():
    Aj = _banded(64, (-3, 0, 2))
    At = operator_from_numpy(Aj, device="cpu")
    dense = np.asarray(Aj.to_dense())
    np.testing.assert_array_equal(At.to_dense().numpy(), dense)
    back = tspmv.DiaMatrix.from_dense(dense, device="cpu")
    assert back.offsets == (-3, 0, 2)
    np.testing.assert_array_equal(back.to_dense().numpy(), dense)


@pytest.mark.parametrize("ncols", [0, 4])
def test_ell_matvec_matches_jax(ncols):
    a = _sparse(500)
    Aj = jspmv.EllMatrix.from_scipy(a)
    At = operator_from_numpy(Aj, device="cpu")
    ref = tspmv.EllMatrix.from_scipy(a, device="cpu")
    np.testing.assert_array_equal(At.vals.numpy(), ref.vals.numpy())
    np.testing.assert_array_equal(At.cols.numpy(), ref.cols.numpy())
    x = np.random.default_rng(2).standard_normal((500, ncols) if ncols else 500)
    want = np.asarray(Aj.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(At.matvec(torch.as_tensor(x)).numpy(), want, rtol=RTOL,
                               atol=1e-14)
    np.testing.assert_allclose(At.to_dense().numpy(), a.toarray(), rtol=RTOL)


def test_ell_from_dense_and_exact_nnz_match_jax():
    # a dense matrix with empty rows and explicit zeros among its stored
    # entries: nnz counts the padded planes, exact_nnz the nonzeros
    a = _sparse(300).toarray()
    a[[7, 150]] = 0.0
    Aj = jspmv.EllMatrix.from_dense(a)
    At = tspmv.EllMatrix.from_dense(a, device="cpu")
    np.testing.assert_array_equal(At.vals.numpy(), np.asarray(Aj.vals))
    np.testing.assert_array_equal(At.cols.numpy(), np.asarray(Aj.cols))
    np.testing.assert_array_equal(At.to_dense().numpy(), a)
    assert At.nnz == Aj.nnz > At.exact_nnz() == Aj.exact_nnz() == np.count_nonzero(a)
    zeroed = tspmv.EllMatrix(vals=At.vals.clone(), cols=At.cols)
    zeroed.vals[0, 0] = 0.0
    assert zeroed.exact_nnz() == At.exact_nnz() - 1


def test_dense_matvec_matches_jax():
    a = np.random.default_rng(3).standard_normal((64, 64))
    Aj = jspmv.DenseMatrix(a=jnp.asarray(a))
    At = operator_from_numpy(Aj, device="cpu")
    x = np.random.default_rng(4).standard_normal(64)
    np.testing.assert_allclose(At.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(Aj.matvec(jnp.asarray(x))), rtol=RTOL)


@pytest.mark.parametrize("kind", ["dia", "ell", "dense"])
def test_normest_matches_jax(kind):
    n = 600
    if kind == "dia":
        Aj = _banded(n, (-2, 0, 2), seed=5)
    elif kind == "ell":
        Aj = jspmv.EllMatrix.from_scipy(_sparse(n, seed=6))
    else:
        Aj = jspmv.DenseMatrix(a=jnp.asarray(_sparse(n, seed=7).toarray()))
    got = tspmv.normest(operator_from_numpy(Aj, device="cpu"))
    want = jspmv.normest(Aj)
    assert got == pytest.approx(want, rel=1e-12)


def test_normest_f32_operator_runs_in_f32():
    Aj = _banded(300, (-1, 0, 1), seed=8)
    At = operator_from_numpy(Aj, device="cpu")
    A32 = tspmv.DiaMatrix(data=At.data.float(), offsets=At.offsets)
    # f32 power iteration: same estimate to f32 accuracy
    assert tspmv.normest(A32) == pytest.approx(tspmv.normest(At), rel=1e-5)


def test_spmv_is_matvec():
    At = operator_from_numpy(_banded(100, (0, 1)), device="cpu")
    x = torch.ones(100, dtype=torch.float64)
    torch.testing.assert_close(tspmv.spmv(At, x), At.matvec(x))


def test_spmv_sends_cuda_vectors_of_dia_to_k2_only():
    from ca_lanczos_tpu_torch.ops import cuda_spmv

    assert tspmv.CUDA_MATVEC[tspmv.DiaMatrix] is cuda_spmv.dia_matvec
    At = operator_from_numpy(_banded(100, (-1, 0, 1)), device="cpu")
    before = dict(cuda_spmv.LAUNCHES)
    torch.testing.assert_close(tspmv.spmv(At, torch.ones(100, dtype=torch.float64)),
                               At.matvec(torch.ones(100, dtype=torch.float64)))
    assert cuda_spmv.LAUNCHES == before  # a CPU vector never counts a launch
