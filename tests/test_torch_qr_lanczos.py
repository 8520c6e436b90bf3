"""PyTorch port, ops/qr.py, solvers/lanczos.py, solvers/ca_lanczos.py and
the copied host modules (config, basis): parity with the JAX package on
identical numpy inputs, float64.

Tolerances: R factors 1e-12 relative and ||Q^T Q - I|| <= 1e-12 (CholQR2
is orthonormal to roundoff at these condition numbers); Lanczos T and
Bk 1e-10 (a 2s-step recurrence amplifies last-bit differences)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ca_lanczos_tpu.basis.leja import leja as jleja
from ca_lanczos_tpu.basis.newton import newton_basis_matrix as jnewton
from ca_lanczos_tpu.config import Orth as JOrth
from ca_lanczos_tpu.ops import qr as jqr
from ca_lanczos_tpu.solvers.ca_lanczos import build_basis_matrix as jbuild
from ca_lanczos_tpu.solvers.lanczos import lanczos as jlanczos
from ca_lanczos_tpu.utils.matrices import laplacian_1d as jlap1, laplacian_2d as jlap2
from ca_lanczos_tpu_torch import config as tconfig
from ca_lanczos_tpu_torch.basis.leja import leja as tleja
from ca_lanczos_tpu_torch.basis.newton import newton_basis_matrix as tnewton
from ca_lanczos_tpu_torch.config import Basis, Orth
from ca_lanczos_tpu_torch.ops import qr as tqr
from ca_lanczos_tpu_torch.solvers.ca_lanczos import build_basis_matrix, monomial_basis_matrix
from ca_lanczos_tpu_torch.solvers.lanczos import lanczos
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy
from ca_lanczos_tpu_torch.utils.matrices import diag_spectrum, laplacian_1d, laplacian_2d


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(n=3000, m=9, cond=1e3, seed=0):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, m)))
    V, _ = np.linalg.qr(rng.standard_normal((m, m)))
    return (U * np.logspace(0, np.log10(cond), m)) @ V.T


@pytest.mark.parametrize("name", ["cholqr2", "cholqr2_mp", "cholqr", "tsqr"])
def test_qr_matches_jax(name):
    X = _block()
    Qj, Rj = getattr(jqr, name)(jnp.asarray(X))
    Q, R = getattr(tqr, name)(torch.as_tensor(X))
    Rj = np.asarray(Rj)
    np.testing.assert_allclose(R.numpy(), Rj, rtol=0, atol=1e-12 * np.abs(Rj).max())
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=0, atol=1e-10)
    if name != "cholqr":  # one CholQR pass is only orthonormal to ~eps*cond^2
        err = np.linalg.norm(Q.numpy().T @ Q.numpy() - np.eye(X.shape[1]))
        assert err <= 1e-12


def test_cholqr2_mp_f32_storage_f64_factors():
    X = _block(cond=10.0).astype(np.float32)
    Q, R = tqr.cholqr2_mp(torch.as_tensor(X))
    Qj, Rj = jqr.cholqr2_mp(jnp.asarray(X))
    assert Q.dtype == torch.float32 and R.dtype == torch.float64
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(Rj)).max())


def test_chol_safe_shifts_on_breakdown():
    # rank-deficient Gram: the unshifted Cholesky fails, the shifted one is finite
    X = np.random.default_rng(1).standard_normal((200, 4))
    X[:, 3] = X[:, 0]
    G = X.T @ X
    L = tqr._chol_safe(torch.as_tensor(G))
    Lj = np.asarray(jqr._chol_safe(jnp.asarray(G)))
    assert torch.isfinite(L).all()
    np.testing.assert_allclose(L.numpy(), Lj, rtol=1e-10, atol=1e-10)


def test_mixed_precision_helpers_match_jax():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((500, 5)).astype(np.float32)
    Y = rng.standard_normal((500, 3)).astype(np.float32)
    G = tqr.gram_f64(torch.as_tensor(X), torch.as_tensor(Y))
    np.testing.assert_allclose(G.numpy(), np.asarray(jqr.gram_f64(jnp.asarray(X),
                                                                  jnp.asarray(Y))), rtol=1e-12)
    R = np.triu(rng.standard_normal((3, 3))) + 3 * np.eye(3)
    S = tqr.sub_proj_f64(torch.as_tensor(Y), torch.as_tensor(Y), torch.as_tensor(R))
    Sj = jqr.sub_proj_f64(jnp.asarray(Y), jnp.asarray(Y), jnp.asarray(R))
    assert S.dtype == torch.float32
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-6, atol=1e-6)
    Z = tqr.rsolve_f64(torch.as_tensor(Y), torch.as_tensor(R))
    np.testing.assert_allclose(Z.numpy(), np.asarray(jqr.rsolve_f64(jnp.asarray(Y),
                                                                    jnp.asarray(R))), rtol=1e-6)


@pytest.mark.parametrize("orth", ["local", "full"])
@pytest.mark.parametrize("fixture", ["lap1", "lap2"])
def test_lanczos_T_matches_jax(orth, fixture):
    Aj = jlap1(500) if fixture == "lap1" else jlap2(20, 25)
    A = operator_from_numpy(Aj, device="cpu")
    r = np.random.default_rng(3).standard_normal(A.n)
    rj = jlanczos(Aj, jnp.asarray(r), 24, JOrth(orth))
    rt = lanczos(A, torch.as_tensor(r), 24, Orth(orth))
    np.testing.assert_allclose(rt.T, rj.T, rtol=0, atol=1e-10 * np.abs(rj.T).max())
    assert rt.Q.shape == (A.n, 24)
    if orth == "full":
        Q = rt.Q.numpy()
        assert np.linalg.norm(Q.T @ Q - np.eye(24)) < 1e-12
    np.testing.assert_allclose(rt.T_ext, rj.T_ext, rtol=0, atol=1e-10 * np.abs(rj.T).max())


def test_lanczos_unported_modes_raise():
    A = laplacian_1d(50, device="cpu")
    r = torch.ones(50, dtype=torch.float64)
    for orth in (Orth.PERIODIC, Orth.SELECTIVE):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lanczos(A, r, 5, orth)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lanczos(A, r, 5, Orth.FULL, diagnostics=True)


@pytest.mark.parametrize("s", [4, 8])
def test_build_basis_matrix_matches_jax(s):
    Aj = jlap2(30, 30)
    A = operator_from_numpy(Aj, device="cpu")
    q = np.random.default_rng(4).standard_normal(A.n)
    q /= np.linalg.norm(q)
    Bj = np.asarray(jbuild(Aj, jnp.asarray(q), s, "newton"))
    Bt = build_basis_matrix(A, torch.as_tensor(q), s, Basis.NEWTON)
    np.testing.assert_allclose(Bt, Bj, rtol=0, atol=1e-10 * np.abs(Bj).max())
    np.testing.assert_array_equal(build_basis_matrix(A, torch.as_tensor(q), s, "monomial"),
                                  monomial_basis_matrix(s))


@pytest.mark.parametrize("variant", ["nonmodified", "modified", "real", "complex"])
def test_copied_leja_and_newton_are_identical(variant):
    pts = np.array([3.0, 1.0 + 2.0j, 1.0 - 2.0j, -2.0, 0.5, 0.5])
    if variant == "nonmodified":
        pts = np.array([3.0, -1.0, 0.25, 2.0, -2.5])
    if variant == "complex":
        pts = np.array([3.0, 1.0 + 2.0j, -2.0, 0.5 - 1.0j])
    if variant == "modified":
        pts = np.array([3.0, 1.0 + 2.0j, 1.0 - 2.0j, -2.0, 0.5])
    got = tleja(pts, tconfig.LejaVariant(variant))
    want = jleja(pts, variant)
    np.testing.assert_array_equal(got, want)
    if variant == "real":
        np.testing.assert_array_equal(tnewton(got, 4, modified=True),
                                      jnewton(want, 4, modified=True))


def test_fixtures_match_jax_planes():
    np.testing.assert_array_equal(laplacian_1d(40, device="cpu").data.numpy(),
                                  np.asarray(jlap1(40).data))
    np.testing.assert_array_equal(laplacian_2d(5, 6, device="cpu").data.numpy(),
                                  np.asarray(jlap2(5, 6).data))
    assert laplacian_2d(5, 6, device="cpu").offsets == jlap2(5, 6).offsets
    np.testing.assert_allclose(diag_spectrum(10, device="cpu").data.numpy()[0],
                               np.linspace(1, 100, 10))
