"""PyTorch port, ops/qr.py, solvers/lanczos.py (all four orth modes and
diagnostics), solvers/ca_lanczos.py (the driver over basis x orth),
utils/diagnostics.py and the copied host modules (config, basis,
solvers/_block.py, OmegaRecurrence): parity with the JAX package on
identical numpy inputs, float64.

Tolerances: R factors 1e-12 relative and ||Q^T Q - I|| <= 1e-12 (CholQR2
is orthonormal to roundoff at these condition numbers); Lanczos and
CA-Lanczos T and Bk 1e-10 relative to their largest entry (a recurrence
amplifies last-bit differences), Lanczos Q 1e-8; diagnostics 1e-8; the
copied host modules are bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ca_lanczos_tpu.basis.leja import leja as jleja
from ca_lanczos_tpu.basis.newton import newton_basis_matrix as jnewton
from ca_lanczos_tpu.config import Orth as JOrth
from ca_lanczos_tpu.ops import qr as jqr
from ca_lanczos_tpu.config import Basis as JBasis
from ca_lanczos_tpu.solvers.ca_lanczos import build_basis_matrix as jbuild
from ca_lanczos_tpu.solvers.ca_lanczos import ca_lanczos as jca_lanczos
from ca_lanczos_tpu.solvers.lanczos import lanczos as jlanczos
from ca_lanczos_tpu.utils.matrices import diag_spectrum as jdiag
from ca_lanczos_tpu.utils.matrices import laplacian_1d as jlap1, laplacian_2d as jlap2
from ca_lanczos_tpu_torch import config as tconfig
from ca_lanczos_tpu_torch.basis.leja import leja as tleja
from ca_lanczos_tpu_torch.basis.newton import newton_basis_matrix as tnewton
from ca_lanczos_tpu_torch.config import Basis, Orth
from ca_lanczos_tpu_torch.ops import qr as tqr
from ca_lanczos_tpu_torch.solvers.ca_lanczos import (
    build_basis_matrix,
    ca_lanczos,
    monomial_basis_matrix,
)
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


def _geo(n=300):
    """Geometric spectrum logspace(0, 4): local orth loses orthogonality on
    it (tests/test_lanczos.py), so periodic and selective both act."""
    return np.logspace(0, 4, n)


def _diag_pair(d):
    from ca_lanczos_tpu.ops.spmv import DiaMatrix as JDia

    Aj = JDia(data=jnp.asarray(np.asarray(d, np.float64))[None, :], offsets=(0,))
    return Aj, operator_from_numpy(Aj, device="cpu")


@pytest.mark.parametrize("orth", ["periodic", "selective"])
def test_lanczos_periodic_selective_match_jax(orth):
    Aj, A = _diag_pair(_geo())
    r = np.random.default_rng(0).standard_normal(A.n)
    rj = jlanczos(Aj, jnp.asarray(r), 60, JOrth(orth))
    rt = lanczos(A, torch.as_tensor(r), 60, Orth(orth))
    assert rt.n_reorth == rj.n_reorth > 0
    np.testing.assert_allclose(rt.T, rj.T, rtol=0, atol=1e-10 * np.abs(rj.T).max())
    np.testing.assert_allclose(rt.Q.numpy(), np.asarray(rj.Q), rtol=0, atol=1e-8)


@pytest.mark.parametrize("orth", ["local", "full", "periodic", "selective"])
def test_lanczos_diagnostics_match_jax(orth):
    Aj = jdiag(100, 1.0, 10.0)
    A = operator_from_numpy(Aj, device="cpu")
    rj = jlanczos(Aj, jnp.ones(100), 15, JOrth(orth), diagnostics=True)
    rt = lanczos(A, torch.ones(100, dtype=torch.float64), 15, Orth(orth), diagnostics=True)
    assert rt.ritz_rnorm.shape == (15, 15) and rt.orth_err.shape == (15,)
    np.testing.assert_allclose(rt.ritz_rnorm, rj.ritz_rnorm, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(rt.orth_err, rj.orth_err, rtol=0, atol=1e-8)
    assert rt.ritz_rnorm[-1, 0] < rt.ritz_rnorm[2, 0]


@pytest.mark.parametrize("orth", ["local", "full", "periodic", "selective"])
@pytest.mark.parametrize("basis", ["monomial", "newton"])
def test_ca_lanczos_matches_jax(orth, basis):
    # tests/test_ca_lanczos.py's geometric spectrum at s = 4 over 60 steps,
    # where periodic and selective act.  Local orth loses orthogonality
    # there and its ghost copies appear where last bits decide (in both
    # packages alike), so it runs on the 2-D Laplacian, which keeps it.
    if orth == "local":
        Aj = jlap2(20, 15)
        A = operator_from_numpy(Aj, device="cpu")
    else:
        Aj, A = _diag_pair(_geo())
    r = np.random.default_rng(4).standard_normal(A.n)
    rj = jca_lanczos(Aj, jnp.asarray(r), 4, 60, JBasis(basis), JOrth(orth))
    rt = ca_lanczos(A, torch.as_tensor(r), 4, 60, Basis(basis), Orth(orth))
    assert rt.n_reorth == rj.n_reorth
    assert (rt.n_reorth > 0) == (orth in ("periodic", "selective"))
    np.testing.assert_allclose(rt.Bk, rj.Bk, rtol=0, atol=1e-10 * np.abs(rj.Bk).max())
    np.testing.assert_allclose(rt.T, rj.T, rtol=0, atol=1e-10 * np.abs(rj.T).max())
    np.testing.assert_allclose(rt.beta, rj.beta, rtol=1e-10)
    assert rt.Q.shape == (A.n, 60) and rt.T_ext.shape == (61, 60)


@pytest.mark.parametrize("s", [2, 4, 6])
def test_ca_lanczos_monomial_full_equals_standard(s):
    Aj = jlap2(10, 10)
    A = operator_from_numpy(Aj, device="cpu")
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(100))
    std = lanczos(A, r, 4 * s, Orth.FULL)
    ca = ca_lanczos(A, r, s, 4 * s, Basis.MONOMIAL, Orth.FULL)
    caj = jca_lanczos(Aj, jnp.asarray(r.numpy()), s, 4 * s, JBasis.MONOMIAL, JOrth.FULL)
    np.testing.assert_allclose(ca.T, caj.T, rtol=0, atol=1e-10 * np.abs(caj.T).max())
    np.testing.assert_allclose(ca.T, std.T, atol=1e-7 * np.abs(std.T).max())


def test_ca_lanczos_diagnostics_match_jax():
    Aj = jdiag(100, 1.0, 10.0)
    A = operator_from_numpy(Aj, device="cpu")
    rj = jca_lanczos(Aj, jnp.ones(100), 4, 16, JBasis.MONOMIAL, JOrth.LOCAL, diagnostics=True)
    rt = ca_lanczos(A, torch.ones(100, dtype=torch.float64), 4, 16, Basis.MONOMIAL,
                    Orth.LOCAL, diagnostics=True, Bk=monomial_basis_matrix(4))
    assert rt.ritz_rnorm.shape == (4, 16) and rt.orth_err.shape == (4,)
    np.testing.assert_allclose(rt.ritz_rnorm, rj.ritz_rnorm, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(rt.orth_err, rj.orth_err, rtol=0, atol=1e-8)


def test_copied_block_recurrence_is_identical():
    from ca_lanczos_tpu.solvers import _block as jblock
    from ca_lanczos_tpu_torch.solvers import _block as tblock

    rng = np.random.default_rng(8)
    s = 5
    Bk = tnewton(np.linspace(1.0, 3.0, s), s, modified=True)
    Rk = np.triu(rng.standard_normal((s + 1, s + 1))) + 4 * np.eye(s + 1)
    Rkk_s = rng.standard_normal((s + 1, s))
    Rk_s = np.triu(rng.standard_normal((s, s))) + 4 * np.eye(s)
    for rcond in (None, 1e-12):
        a = tblock.first_block_T(Rk, Bk, s, rcond)
        b = jblock.first_block_T(Rk, Bk, s, rcond)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        a = tblock.block_T(Rkk_s, Rk_s, Bk, 0.7, s, rcond)
        b = jblock.block_T(Rkk_s, Rk_s, Bk, 0.7, s, rcond)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    T0 = tblock.first_block_T(Rk, Bk, s)[0]
    Tk = tblock.block_T(Rkk_s, Rk_s, Bk, 0.7, s)[0]
    np.testing.assert_array_equal(tblock.extend_T(T0, Tk, 0.7, 0.3, s),
                                  jblock.extend_T(T0, Tk, 0.7, 0.3, s))


def test_copied_omega_recurrence_is_identical():
    from ca_lanczos_tpu.utils.diagnostics import OmegaRecurrence as JOmega
    from ca_lanczos_tpu_torch.utils.diagnostics import OmegaRecurrence

    rng = np.random.default_rng(9)
    alpha, beta = rng.standard_normal(24), np.abs(rng.standard_normal(25)) + 0.1
    a, b = OmegaRecurrence(7.0), JOmega(7.0)
    for n in (4, 8, 16, 24):
        np.testing.assert_array_equal(a.update(alpha[:n], beta[:n + 1]),
                                      b.update(alpha[:n], beta[:n + 1]))
        assert a.max_error_scalar() == b.max_error_scalar()
        assert a.max_error_block(4) == b.max_error_block(4)
    a.reset_scalar(), b.reset_scalar()
    np.testing.assert_array_equal(a.omega, b.omega)
    a.reset_block(4), b.reset_block(4)
    np.testing.assert_array_equal(a.omega, b.omega)


def test_orth_errors_match_jax():
    from ca_lanczos_tpu.utils import diagnostics as jdiagn
    from ca_lanczos_tpu_torch.utils import diagnostics as tdiagn

    rng = np.random.default_rng(10)
    Q = np.linalg.qr(rng.standard_normal((300, 12)))[0] + 1e-9 * rng.standard_normal((300, 12))
    Qt = torch.as_tensor(Q)
    assert tdiagn.orth_error_fro(Qt) == pytest.approx(jdiagn.orth_error_fro(Q), rel=1e-6)
    # a sequence of blocks is their concatenation
    assert tdiagn.orth_error_fro([Qt[:, :5], Qt[:, 5:]]) == pytest.approx(
        jdiagn.orth_error_fro(Q), rel=1e-6)
    assert tdiagn.orth_error_last(Qt) == pytest.approx(jdiagn.orth_error_last(Q), rel=1e-6)
    for s in (3, 11, 12):
        assert tdiagn.orth_error_block(Qt, s) == pytest.approx(
            jdiagn.orth_error_block(Q, s), rel=1e-6)
    Qc = Q + 1j * np.linalg.qr(rng.standard_normal((300, 12)))[0]
    assert tdiagn.orth_error_fro(torch.as_tensor(Qc)) == pytest.approx(
        jdiagn.orth_error_fro(Qc), rel=1e-10)


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


def test_copied_qrstep_and_retridiagonalize_are_identical():
    from ca_lanczos_tpu.solvers import implicitly_restarted as jirl
    from ca_lanczos_tpu_torch.solvers import implicitly_restarted as tirl

    rng = np.random.default_rng(11)
    m = 12
    a, b = rng.standard_normal(m), rng.standard_normal(m - 1)
    T = np.diag(a) + np.diag(b, 1) + np.diag(b, -1)
    for mu, k1 in ((np.linalg.eigvalsh(T)[0], 0), (0.3 + 0.2j, 3)):
        Vt, Ht = tirl.qrstep(np.eye(m), T.copy(), mu, k1, m)
        Vj, Hj = jirl.qrstep(np.eye(m), T.copy(), mu, k1, m)
        np.testing.assert_array_equal(Vt, Vj)
        np.testing.assert_array_equal(Ht, Hj)
    d = np.sort(rng.standard_normal(9))
    w = rng.standard_normal(9)
    w[4] = 0.0
    for x, y in zip(tirl._retridiagonalize(d, w), jirl._retridiagonalize(d, w)):
        np.testing.assert_array_equal(x, y)


def test_copied_checkpoint_reads_and_writes_the_jax_format(tmp_path):
    from ca_lanczos_tpu.utils.checkpoint import RestartCheckpoint as JCheckpoint
    from ca_lanczos_tpu_torch.utils.checkpoint import RestartCheckpoint

    rng = np.random.default_rng(12)
    gen = np.random.default_rng(3)
    gen.random(5)
    fields = dict(n_restarts=4, nconv=2, conv_eigs=[3.0, 2.5], conv_rnorms=[1e-9, 2e-9],
                  orth_err=[1e-14] * 4, rnorm_rows=[rng.random(3) for _ in range(4)],
                  Q_conv=rng.random((50, 2)), q=rng.random(50), Bk=rng.random((5, 4)),
                  rng_state=gen.bit_generator.state)
    for writer, reader in ((RestartCheckpoint, JCheckpoint), (JCheckpoint, RestartCheckpoint)):
        path = str(tmp_path / f"{writer.__module__}.npz")
        writer(**fields).save(path)
        got = reader.load(path)
        for key, want in fields.items():
            val = getattr(got, key)
            if key == "rng_state":
                assert val == want
            else:
                np.testing.assert_array_equal(np.asarray(val), np.asarray(want))
    empty = dict(fields, Q_conv=None, rnorm_rows=[])
    path = str(tmp_path / "empty.npz")
    RestartCheckpoint(**empty).save(path)
    got = JCheckpoint.load(path)
    assert got.Q_conv is None and got.rnorm_rows == []
