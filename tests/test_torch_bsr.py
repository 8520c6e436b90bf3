"""PyTorch port, ops/bsr.py against the JAX package on identical numpy
inputs (float64, ``device="cpu"``); mirrors TestBsr and TestBsrToDia of
tests/test_bsr.py, plus the carry-across of a JAX BsrMatrix by
``operator_from_numpy`` (which once took it for an ELL matrix: both have
``vals`` and ``cols``).

Tolerances: matvecs 1e-12 absolute against the JAX package's and the dense
product (values O(1)); ``to_dense`` and ``to_dia`` exact (== the JAX
planes, bit for bit); the construction identical (vals and cols equal);
matrix powers 1e-10; the top Ritz value of ``ca_lanczos`` 1e-8 relative
to the exact one and 1e-10 to the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ca_lanczos_tpu.config import Basis as JBasis
from ca_lanczos_tpu.config import Orth as JOrth
from ca_lanczos_tpu.ops.bsr import BsrMatrix as JBsr
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_monomial as jpowers
from ca_lanczos_tpu.solvers.ca_lanczos import ca_lanczos as jca
from ca_lanczos_tpu_torch.config import Basis, Orth
from ca_lanczos_tpu_torch.ops.bsr import BsrMatrix
from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers_monomial
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, EllMatrix, spmv
from ca_lanczos_tpu_torch.solvers.ca_lanczos import ca_lanczos
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_laplacian(n_blocks=16, bs=4, seed=0):
    """SPD block-tridiagonal matrix with dense (bs, bs) blocks (the JAX
    test's fixture)."""
    rng = np.random.default_rng(seed)
    n = n_blocks * bs
    dense = np.zeros((n, n))
    for i in range(n_blocks):
        B = rng.standard_normal((bs, bs)) * 0.1
        dense[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = B @ B.T + 4 * np.eye(bs)
        if i + 1 < n_blocks:
            C = rng.standard_normal((bs, bs)) * 0.2
            dense[i * bs:(i + 1) * bs, (i + 1) * bs:(i + 2) * bs] = C
            dense[(i + 1) * bs:(i + 2) * bs, i * bs:(i + 1) * bs] = C.T
    return dense


def _pair(dense, bs):
    return JBsr.from_dense(dense, block_size=bs), BsrMatrix.from_dense(dense, bs, device="cpu")


class TestBsr:
    def test_construction_matches_jax(self):
        Aj, A = _pair(_block_laplacian(), 4)
        np.testing.assert_array_equal(A.vals.numpy(), np.asarray(Aj.vals))
        np.testing.assert_array_equal(A.cols.numpy(), np.asarray(Aj.cols))
        assert (A.n, A.shape, A.block_shape, A.nnz) == (Aj.n, Aj.shape, Aj.block_shape, Aj.nnz)
        assert A.exact_nnz() == Aj.exact_nnz() and A.dtype == torch.float64
        assert A.to("cpu").vals.device.type == "cpu"

    def test_spmv_parity(self):
        dense = _block_laplacian()
        Aj, A = _pair(dense, 4)
        x = np.random.default_rng(1).standard_normal(dense.shape[0])
        y = spmv(A, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(y, np.asarray(Aj.matvec(jnp.asarray(x))), rtol=0, atol=1e-12)
        np.testing.assert_allclose(y, dense @ x, atol=1e-12)
        np.testing.assert_array_equal(A.to_dense().numpy(), np.asarray(Aj.to_dense()))

    def test_multivector(self):
        dense = _block_laplacian()
        Aj, A = _pair(dense, 4)
        X = np.random.default_rng(2).standard_normal((dense.shape[0], 5))
        Y = A.matvec(torch.as_tensor(X)).numpy()
        np.testing.assert_allclose(Y, np.asarray(Aj.matvec(jnp.asarray(X))), rtol=0, atol=1e-12)
        np.testing.assert_allclose(Y, dense @ X, atol=1e-12)

    def test_padding_unaligned_n(self):
        dense = _block_laplacian(n_blocks=7, bs=3)[:20, :20]  # n=20, block 8
        Aj, A = _pair(dense, 8)
        assert A.n == Aj.n == 24
        np.testing.assert_array_equal(A.vals.numpy(), np.asarray(Aj.vals))
        x = np.zeros(24)
        x[:20] = np.random.default_rng(3).standard_normal(20)
        y = A.matvec(torch.as_tensor(x)).numpy()[:20]
        np.testing.assert_allclose(y, dense @ x[:20], atol=1e-12)

    def test_in_ca_lanczos(self):
        dense = _block_laplacian(n_blocks=32, bs=4)
        Aj, A = _pair(dense, 4)
        n = dense.shape[0]
        res = ca_lanczos(A, torch.ones(n, dtype=torch.float64), s=4, total_steps=40,
                         basis=Basis.MONOMIAL, orth=Orth.FULL)
        rj = jca(Aj, jnp.ones(n), s=4, total_steps=40, basis=JBasis.MONOMIAL, orth=JOrth.FULL)
        d = np.sort(np.linalg.eigvalsh(res.T))[::-1]
        exact = np.sort(np.linalg.eigvalsh(dense))[::-1]
        np.testing.assert_allclose(d[0], exact[0], rtol=1e-8)
        np.testing.assert_allclose(d[0], np.sort(np.linalg.eigvalsh(np.asarray(rj.T)))[-1],
                                   rtol=1e-10)

    def test_matrix_powers(self):
        dense = _block_laplacian()
        Aj, A = _pair(dense, 4)
        q = np.random.default_rng(4).standard_normal(dense.shape[0])
        V = matrix_powers_monomial(A, torch.as_tensor(q), 3).numpy()
        ref = np.stack([q] + [np.linalg.matrix_power(dense, k) @ q for k in (1, 2, 3)], axis=1)
        np.testing.assert_allclose(V, ref, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(V, np.asarray(jpowers(Aj, jnp.asarray(q), 3)),
                                   rtol=1e-10, atol=1e-10)


def _block_tridiag_csr(nb, bs, seed):
    rng = np.random.default_rng(seed)
    n = nb * bs
    rows, cols, vals = [], [], []
    for i in range(nb):
        for d in (-1, 0, 1):
            j = i + d
            if 0 <= j < nb:
                T = rng.standard_normal((bs, bs))
                b, c = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
                rows.append((i * bs + b).ravel())
                cols.append((j * bs + c).ravel())
                vals.append(T.ravel())
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         (n, n))


class TestBsrToDia:
    def test_conversion_exact(self):
        a = _block_tridiag_csr(24, 8, seed=0)
        Aj = JBsr.from_scipy(a, block_size=8)
        A = BsrMatrix.from_scipy(a, block_size=8, device="cpu")
        D, Dj = A.to_dia(), Aj.to_dia()
        assert isinstance(D, DiaMatrix) and len(D.offsets) == 31 and D.offsets == Dj.offsets
        np.testing.assert_array_equal(D.data.numpy(), np.asarray(Dj.data))
        np.testing.assert_allclose(D.to_dense().numpy(), a.toarray(), atol=1e-14)

    def test_folds_same_offset_contributions(self):
        """Two stored tiles on one block diagonal of a row (a repeated
        block column) fold into the same scalar planes (+=), as in JAX."""
        a = _block_tridiag_csr(6, 4, seed=5)
        A = BsrMatrix.from_scipy(a, block_size=4, device="cpu")
        vals = torch.cat([A.vals, A.vals[:, :1] * 0.5], dim=1)
        cols = torch.cat([A.cols, A.cols[:, :1]], dim=1)
        B = BsrMatrix(vals=vals, cols=cols)
        Bj = JBsr(vals=jnp.asarray(vals.numpy()), cols=jnp.asarray(cols.numpy(), jnp.int32))
        D, Dj = B.to_dia(), Bj.to_dia()
        np.testing.assert_array_equal(D.data.numpy(), np.asarray(Dj.data))
        np.testing.assert_allclose(D.to_dense().numpy(), B.to_dense().numpy(), atol=1e-14)

    def test_unstructured_raises(self):
        rng = np.random.default_rng(1)
        nb, bs = 64, 8
        n = nb * bs
        rows, cols, vals = [], [], []
        for i in range(nb):
            for j in rng.choice(nb, 3, replace=False):
                rows.append(i * bs)
                cols.append(int(j) * bs)
                vals.append(1.0)
        a = sp.csr_matrix((vals, (rows, cols)), (n, n))
        A = BsrMatrix.from_scipy(a, block_size=bs, device="cpu")
        with pytest.raises(ValueError, match="not band-convertible"):
            A.to_dia(max_offsets=48)


def test_interop_carries_a_jax_bsr_as_bsr():
    dense = _block_laplacian(n_blocks=10, bs=4, seed=6)
    Aj = JBsr.from_dense(dense, block_size=4)
    A = operator_from_numpy(Aj, device="cpu")
    assert isinstance(A, BsrMatrix) and not isinstance(A, EllMatrix)
    assert A.cols.dtype == torch.int64
    x = np.random.default_rng(7).standard_normal(dense.shape[0])
    np.testing.assert_allclose(spmv(A, torch.as_tensor(x)).numpy(),
                               np.asarray(Aj.matvec(jnp.asarray(x))), rtol=0, atol=1e-12)
    # an ELL operator (2-D vals) still carries across as ELL
    from ca_lanczos_tpu.ops.spmv import EllMatrix as JEll

    E = operator_from_numpy(JEll(vals=jnp.ones((5, 2)), cols=jnp.zeros((5, 2), jnp.int32)),
                            device="cpu")
    assert isinstance(E, EllMatrix)
