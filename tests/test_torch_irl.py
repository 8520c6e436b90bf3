"""PyTorch port, solvers/implicitly_restarted.py (the IRL with locking and
purging) and solvers/arnoldi.py against the JAX package on identical
numpy inputs, float64 (mirrors tests/test_irl_arnoldi.py).

Tolerances: eigenvalues rtol 1e-10; n_restarts, n_locked and n_purged
equal; locked vectors 1e-8 up to sign; Arnoldi (Q, H) 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ca_lanczos_tpu.config import Basis as JBasis
from ca_lanczos_tpu.config import Orth as JOrth
from ca_lanczos_tpu.ops.formats import make_operator as jmake_operator
from ca_lanczos_tpu.ops.spmv import DiaMatrix as JDia
from ca_lanczos_tpu.solvers.arnoldi import arnoldi as jarnoldi
from ca_lanczos_tpu.solvers.implicitly_restarted import impl_restarted_ca_lanczos as jirl
from ca_lanczos_tpu.utils.matrices import diag_spectrum as jdiag
from ca_lanczos_tpu.utils.matrices import laplacian_1d as jlap1
from ca_lanczos_tpu_torch.config import Basis, Orth
from ca_lanczos_tpu_torch.ops.formats import make_operator
from ca_lanczos_tpu_torch.solvers.arnoldi import arnoldi
from ca_lanczos_tpu_torch.solvers.implicitly_restarted import impl_restarted_ca_lanczos
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(Aj):
    return Aj, operator_from_numpy(Aj, device="cpu")


def _run_both(Aj, A, n, **kw):
    rj = jirl(Aj, jnp.ones(n), **{k: JBasis(v) if k == "basis" else JOrth(v) if k == "orth"
                                   else v for k, v in kw.items()})
    rt = impl_restarted_ca_lanczos(A, torch.ones(n, dtype=torch.float64),
                                   **{k: Basis(v) if k == "basis" else Orth(v) if k == "orth"
                                      else v for k, v in kw.items()})
    assert rt.converged == rj.converged
    assert (rt.n_restarts, rt.n_locked, rt.n_purged) == (rj.n_restarts, rj.n_locked, rj.n_purged)
    np.testing.assert_allclose(rt.eigs, rj.eigs, rtol=1e-10)
    Qt, Qj = rt.Q_conv.numpy(), np.asarray(rj.Q_conv)
    signs = np.sign(np.sum(Qt * Qj, axis=0))
    np.testing.assert_allclose(Qt * signs, Qj, rtol=0, atol=1e-8)
    return rt


@pytest.mark.parametrize("inner", ["std", "ca", "arnoldi"])
def test_irl_diagonal_matches_jax(inner):
    Aj, A = _pair(jdiag(400, 1.0, 100.0))
    rt = _run_both(Aj, A, 400, max_lanczos=40, n_wanted=6, s=4, basis="monomial",
                   orth="full", tol=1e-8, inner=inner)
    assert rt.converged
    np.testing.assert_allclose(rt.eigs, np.linspace(1, 100, 400)[::-1][:6], rtol=1e-6)


def test_irl_newton_basis_matches_jax():
    Aj, A = _pair(jdiag(300, 1.0, 50.0))
    rt = _run_both(Aj, A, 300, max_lanczos=36, n_wanted=4, s=4, basis="newton",
                   orth="full", tol=1e-8, inner="ca")
    assert rt.converged
    np.testing.assert_allclose(rt.eigs, np.linspace(1, 50, 300)[::-1][:4], rtol=1e-6)


def _clustered(n=500):
    """tests/test_irl_arnoldi.py TestIRLLocking: a clustered top, hard for
    a non-deflating IRL."""
    vals = np.concatenate([np.linspace(1.0, 50.0, n - 8),
                           np.array([99.0, 99.2, 99.4, 99.6, 100.0, 100.1, 100.2, 100.3])])
    return _pair(JDia(data=jnp.asarray(vals)[None, :], offsets=(0,))), np.sort(vals)[::-1]


@pytest.mark.parametrize("inner,basis,lock", [
    ("std", "monomial", True), ("ca", "monomial", True), ("ca", "newton", True),
    ("arnoldi", "monomial", True), ("std", "monomial", False),
])
def test_irl_locking_matches_jax(inner, basis, lock):
    (Aj, A), exact = _clustered()
    rt = _run_both(Aj, A, 500, max_lanczos=40, n_wanted=6, s=4, basis=basis, orth="full",
                   tol=1e-9, inner=inner, lock=lock, max_restarts=60)
    assert rt.converged
    assert (rt.n_locked >= 6) == lock
    np.testing.assert_allclose(rt.eigs, exact[:6], rtol=1e-7)
    # every returned pair is a true eigenpair, not just a T-estimate
    Q = rt.Q_conv
    resid = torch.linalg.norm(A.matvec(Q) - Q * torch.as_tensor(rt.eigs)[None, :], dim=0)
    assert float(resid.max()) < 1e-6 * 100.0


def test_irl_f32_breakdown_is_the_jax_packages():
    # In float32 the CA extension at s = 8 breaks down on the clustered
    # band (T entries grow far past |A| and the per-restart Newton refresh
    # feeds those Ritz values back as shifts) until the R factors hold
    # NaN: both packages raise.  chip_smoke.py's phase F therefore runs
    # this recipe in float64.
    n = 2048
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = 99.0 + 0.01 * np.arange(10)
    off = np.random.default_rng(0).standard_normal(n) * 1e-3
    off[n - 11:] = 0.0
    a = sp.diags([off[:-1], d, off[:-1]], [-1, 0, 1], format="csr").astype(np.float32)
    Aj, _ = jmake_operator(a, prefer="dia")
    A, _ = make_operator(a, prefer="dia", device="cpu")
    kw = dict(n_wanted=13, s=8, tol=1e-4, max_restarts=200)
    with pytest.raises(np.linalg.LinAlgError):
        jirl(Aj, jnp.ones(n, jnp.float32), 48, **kw)
    with pytest.raises(np.linalg.LinAlgError):
        impl_restarted_ca_lanczos(A, torch.ones(n), 48, **kw)


def test_arnoldi_matches_jax():
    Aj, A = _pair(jlap1(200))
    q = np.random.default_rng(0).standard_normal(200)
    Qj, Hj = jarnoldi(Aj, jnp.asarray(q), 20)
    Q, H = arnoldi(A, torch.as_tensor(q), 20)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(H, Hj, rtol=0, atol=1e-10)
    Qn = Q.numpy()
    np.testing.assert_allclose(A.to_dense().numpy() @ Qn[:, :20], Qn @ H, atol=1e-11)
    np.testing.assert_allclose(Qn.T @ Qn, np.eye(21), atol=1e-12)


@pytest.mark.parametrize("reorth", [False, True])
def test_arnoldi_extension_matches_jax(reorth):
    Aj, A = _pair(jlap1(150))
    q = np.random.default_rng(1).standard_normal(150)
    Q1j, H1j = jarnoldi(Aj, jnp.asarray(q), 8, reorth=reorth)
    Q2j, H2j = jarnoldi(Aj, jnp.asarray(q), 16, Q=Q1j, H=H1j, prevvecs=8, reorth=reorth)
    Q1, H1 = arnoldi(A, torch.as_tensor(q), 8, reorth=reorth)
    Q2, H2 = arnoldi(A, torch.as_tensor(q), 16, Q=Q1, H=H1, prevvecs=8, reorth=reorth)
    np.testing.assert_allclose(Q2.numpy(), np.asarray(Q2j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(H2, H2j, rtol=0, atol=1e-10)
    Qf, Hf = arnoldi(A, torch.as_tensor(q), 16, reorth=reorth)
    np.testing.assert_allclose(Q2.numpy(), Qf.numpy(), atol=1e-10)
    with pytest.raises(ValueError, match="needs Q and H"):
        arnoldi(A, torch.as_tensor(q), 16, prevvecs=8)
