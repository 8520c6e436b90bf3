"""PyTorch port, solvers/propagators.py and ops/csplit.py against the JAX
package on identical numpy inputs (the harmonic-oscillator Gaussian packet
of runLanczos.m, n = 128, float64/complex128, ``device="cpu"``); mirrors
every class of tests/test_propagators.py.

Tolerances: psi after ``apply_exp`` (and every propagated psi) 1e-10
absolute against the JAX package's, except the monomial CA basis, 1e-7;
the leading 4 x 4 of T 1e-12 relative to max|T| (beyond it reduction-order
roundoff grows ~30x per Krylov step in both packages: the JAX package's
own split and complex T differ by 1e-10 at 10 steps and 1e-2 at 24, while
psi stays converged); the Krylov step counts equal; norm conservation
1e-10; csplit's Gram, projection and Cholesky QR 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from ca_lanczos_tpu.config import Basis as JBasis
from ca_lanczos_tpu.ops import csplit as jcs
from ca_lanczos_tpu.solvers import propagators as jp
from ca_lanczos_tpu.utils.matrices import gaussian_packet as jpacket
from ca_lanczos_tpu.utils.matrices import harmonic_oscillator as jho
from ca_lanczos_tpu_torch.config import Basis
from ca_lanczos_tpu_torch.ops import csplit
from ca_lanczos_tpu_torch.solvers import propagators as tp
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy
from ca_lanczos_tpu_torch.utils.matrices import gaussian_packet, harmonic_oscillator

DT = 0.025
PSI = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ho():
    Hj, x = jho(128, (-10.0, 10.0))
    psi = jpacket(x).astype(np.complex128)
    return Hj, operator_from_numpy(Hj, device="cpu"), psi


@pytest.fixture(scope="module")
def oracle(ho):
    Hj, _, psi = ho
    Hd = np.asarray(Hj.to_dense())
    return lambda t: scipy.linalg.expm(-1j * t * Hd) @ psi


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lead_T(rt, rj, k=4):
    Tj = np.asarray(rj.T)
    err = np.abs(rt.T[:k, :k] - Tj[:k, :k]).max() / np.abs(Tj).max()
    assert err <= 1e-12, err


def _split_c(p):
    p = _np(p)
    return p[:, 0] + 1j * p[:, 1]


def test_fixtures_match_jax():
    H, x = harmonic_oscillator(128, device="cpu")
    Hj, xj = jho(128)
    assert isinstance(H, type(operator_from_numpy(Hj, device="cpu")))
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(H.to_dense().numpy(), np.asarray(Hj.to_dense()))
    np.testing.assert_array_equal(gaussian_packet(x, 0.7, -1.0), jpacket(xj, 0.7, -1.0))


class TestLanczosProp:
    def test_single_step_matches_jax_and_oracle(self, ho, oracle):
        Hj, H, psi = ho
        nrm = float(np.linalg.norm(psi))
        rj = jp.lanczos_prop(Hj, jnp.asarray(psi), 24, DT)
        rt = tp.lanczos_prop(H, torch.as_tensor(psi), 24, DT)
        assert rt.n_steps == rj.n_steps == 24 and tuple(rt.Q.shape) == (128, 24)
        _lead_T(rt, rj)
        out = _np(rt.apply_exp(DT, nrm))
        np.testing.assert_allclose(out, _np(rj.apply_exp(DT, nrm)), rtol=0, atol=PSI)
        assert np.max(np.abs(out - oracle(DT))) < 1e-10

    def test_adaptive_stops_early(self, ho):
        Hj, H, psi = ho
        rj = jp.lanczos_prop(Hj, jnp.asarray(psi), 40, DT, tol=1e-10, adaptive=True)
        rt = tp.lanczos_prop(H, torch.as_tensor(psi), 40, DT, tol=1e-10, adaptive=True)
        assert rt.n_steps == rj.n_steps < 40
        assert rt.residual < 1e-10


class TestCaLanczosProp:
    @pytest.mark.parametrize("basis", ["monomial", "newton"])
    def test_single_step_matches_jax_and_oracle(self, ho, oracle, basis):
        Hj, H, psi = ho
        nrm = float(np.linalg.norm(psi))
        rj = jp.ca_lanczos_prop(Hj, jnp.asarray(psi), s=6, m=4, dt=DT, basis=JBasis(basis))
        rt = tp.ca_lanczos_prop(H, torch.as_tensor(psi), s=6, m=4, dt=DT, basis=Basis(basis))
        assert rt.n_steps == rj.n_steps == 24
        _lead_T(rt, rj)
        out = _np(rt.apply_exp(DT, nrm))
        tol = 1e-7 if basis == "monomial" else PSI
        np.testing.assert_allclose(out, _np(rj.apply_exp(DT, nrm)), rtol=0, atol=tol)
        assert np.max(np.abs(out - oracle(DT))) < (1e-6 if basis == "monomial" else 1e-9)

    def test_eigest_skips_bootstrap(self, ho, oracle):
        Hj, H, psi = ho
        eigest = np.linspace(0.5, 40.0, 12)
        rj = jp.ca_lanczos_prop(Hj, jnp.asarray(psi), s=6, m=4, dt=DT, eigest=eigest)
        rt = tp.ca_lanczos_prop(H, torch.as_tensor(psi), s=6, m=4, dt=DT, eigest=eigest)
        _lead_T(rt, rj)
        out = _np(rt.apply_exp(DT, float(np.linalg.norm(psi))))
        np.testing.assert_allclose(out, _np(rj.apply_exp(DT, float(np.linalg.norm(psi)))),
                                   rtol=0, atol=PSI)
        assert np.max(np.abs(out - oracle(DT))) < 1e-9

    def test_adaptive_residual(self, ho):
        Hj, H, psi = ho
        rj = jp.ca_lanczos_prop(Hj, jnp.asarray(psi), 6, 6, DT, tol=1e-10, adaptive=True)
        rt = tp.ca_lanczos_prop(H, torch.as_tensor(psi), 6, 6, DT, tol=1e-10, adaptive=True)
        assert rt.n_steps == rj.n_steps < 36 and rt.residual < 1e-10


class TestPropagateLoop:
    """runLanczos.m at reduced size (20 steps, N = 128)."""

    @pytest.mark.parametrize("method,basis", [("lanczos", "newton"), ("ca", "newton"),
                                              ("ca", "monomial")])
    def test_matches_jax_and_expm(self, ho, oracle, method, basis):
        Hj, H, psi = ho
        n_steps = 20
        want = _np(jp.propagate(Hj, jnp.asarray(psi), DT, n_steps, krylov_dim=24,
                                method=method, s=6, basis=JBasis(basis)))
        got = _np(tp.propagate(H, torch.as_tensor(psi), DT, n_steps, krylov_dim=24,
                               method=method, s=6, basis=Basis(basis)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 if basis == "monomial" else PSI)
        assert np.max(np.abs(got - oracle(DT * n_steps))) < 1e-8

    def test_norm_conserved(self, ho):
        _, H, psi = ho
        out = tp.propagate(H, torch.as_tensor(psi), DT, 10, krylov_dim=24, method="ca", s=6)
        np.testing.assert_allclose(float(torch.linalg.norm(out)), np.linalg.norm(psi),
                                   rtol=1e-10)

    def test_real_input_taken_complex(self, ho):
        _, H, psi = ho
        a = tp.propagate(H, torch.as_tensor(psi.real), DT, 2)
        b = tp.propagate(H, torch.as_tensor(psi), DT, 2)
        assert a.dtype == torch.complex128
        torch.testing.assert_close(a, b, rtol=0, atol=1e-14)


class TestSplitPath:
    def test_matches_complex_and_jax(self, ho):
        Hj, H, psi = ho
        nrm = float(np.linalg.norm(psi))
        rc = tp.lanczos_prop(H, torch.as_tensor(psi), 20, DT)
        rs = tp.lanczos_prop_split(H, torch.as_tensor(psi), 20, DT)
        rj = jp.lanczos_prop_split(Hj, jnp.asarray(psi), 20, DT)
        assert tuple(rs.Q.shape) == (128, 2, 20)
        np.testing.assert_allclose(rs.T[:8, :8], rc.T[:8, :8], atol=1e-10)
        _lead_T(rs, rj)
        np.testing.assert_allclose(_np(rs.Q)[..., :4], np.asarray(rj.Q)[..., :4], rtol=0,
                                   atol=1e-12)
        out = _split_c(rs.apply_exp(DT, nrm))
        np.testing.assert_allclose(out, _np(rc.apply_exp(DT, nrm)), atol=PSI)
        np.testing.assert_allclose(out, _split_c(rj.apply_exp(DT, nrm)), rtol=0, atol=PSI)

    def test_propagate_split_vs_jax_and_expm(self, ho, oracle):
        Hj, H, psi = ho
        got = _np(tp.propagate_split(H, torch.as_tensor(psi), DT, 10, krylov_dim=24))
        want = jp.propagate_split(Hj, jnp.asarray(psi), DT, 10, krylov_dim=24)
        np.testing.assert_allclose(got, want, rtol=0, atol=PSI)
        assert np.max(np.abs(got - oracle(DT * 10))) < 1e-9

    def test_ca_split_vs_jax_and_oracle(self, ho, oracle):
        Hj, H, psi = ho
        nrm = float(np.linalg.norm(psi))
        rt = tp.ca_lanczos_prop_split(H, torch.as_tensor(psi), s=6, m=4, dt=DT)
        rj = jp.ca_lanczos_prop_split(Hj, jnp.asarray(psi), s=6, m=4, dt=DT)
        assert rt.n_steps == rj.n_steps == 24 and tuple(rt.Q.shape) == (128, 2, 24)
        _lead_T(rt, rj)
        out = _split_c(rt.apply_exp(DT, nrm))
        np.testing.assert_allclose(out, _split_c(rj.apply_exp(DT, nrm)), rtol=0, atol=PSI)
        assert np.max(np.abs(out - oracle(DT))) < 1e-9

    def test_ca_split_residual_adaptive(self, ho):
        Hj, H, psi = ho
        rt = tp.ca_lanczos_prop_split(H, torch.as_tensor(psi), 6, 6, DT, tol=1e-10,
                                      adaptive=True)
        rj = jp.ca_lanczos_prop_split(Hj, jnp.asarray(psi), 6, 6, DT, tol=1e-10,
                                      adaptive=True)
        assert rt.n_steps == rj.n_steps < 36 and rt.residual < 1e-10

    def test_fused_one_call_vs_jax_and_expm(self, ho, oracle):
        Hj, H, psi = ho
        got = _np(tp.propagate_split_fused(H, torch.as_tensor(psi), DT, 20, krylov_dim=24))
        want = jp.propagate_split_fused(Hj, jnp.asarray(psi), DT, 20, krylov_dim=24)
        np.testing.assert_allclose(got, want, rtol=0, atol=PSI)
        assert np.max(np.abs(got - oracle(DT * 20))) < 1e-12

    def test_norm_conserved_split(self, ho):
        _, H, psi = ho
        for out in (tp.propagate_split(H, torch.as_tensor(psi), DT, 10),
                    tp.propagate_split_fused(H, torch.as_tensor(psi), DT, 10)):
            np.testing.assert_allclose(float(torch.linalg.norm(out)), np.linalg.norm(psi),
                                       rtol=1e-10)


class TestFusedAdaptive:
    def test_matches_host_adaptive_jax_and_step_counts(self):
        n, steps, m, tol = 128, 8, 24, 1e-10
        Hj, x = jho(n)
        H = operator_from_numpy(Hj, device="cpu")
        psi0 = jpacket(x).astype(np.complex128)
        psi_f, total_f = tp.propagate_split_fused_steps(H, torch.as_tensor(psi0), DT, steps,
                                                        krylov_dim=m, tol=tol)
        psi_j, total_j = jp.propagate_split_fused_steps(Hj, psi0, DT, steps, krylov_dim=m,
                                                        tol=tol)
        psi_h = tp._to_split(torch.as_tensor(psi0))
        total_h = 0
        for _ in range(steps):
            nrm = float(torch.sqrt(torch.sum(psi_h * psi_h)))
            res = tp.lanczos_prop_split(H, psi_h.T, m, DT, tol, adaptive=True)
            total_h += res.n_steps
            psi_h = res.apply_exp(DT, nrm).T
        assert total_f == total_j == total_h, (total_f, total_j, total_h)
        assert total_f < steps * m
        np.testing.assert_allclose(_np(psi_f), psi_j, rtol=0, atol=PSI)
        np.testing.assert_allclose(_np(psi_f), _np(torch.complex(psi_h[0], psi_h[1])),
                                   atol=1e-9)
        np.testing.assert_allclose(_np(tp.propagate_split_fused(
            H, torch.as_tensor(psi0), DT, steps, krylov_dim=m, adaptive=True, tol=tol)),
            _np(psi_f), rtol=0, atol=0)

    def test_tight_tol_matches_fixed_depth(self):
        Hj, x = jho(128)
        H = operator_from_numpy(Hj, device="cpu")
        psi0 = torch.as_tensor(jpacket(x).astype(np.complex128))
        fix = tp.propagate_split_fused(H, psi0, DT, 5, krylov_dim=16)
        ad = tp.propagate_split_fused(H, psi0, DT, 5, krylov_dim=16, adaptive=True, tol=1e-300)
        np.testing.assert_allclose(_np(ad), _np(fix), atol=1e-12)


class TestCsplit:
    """ops/csplit.py against the JAX package, in its (n, 2, m) layout and on
    views of (m, 2, n) rows."""

    @staticmethod
    def _blocks(n=300, m=5, p=3, seed=0):
        rng = np.random.default_rng(seed)
        Q = np.linalg.qr(rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m)))[0]
        X = rng.standard_normal((n, p)) + 1j * rng.standard_normal((n, p))
        split = lambda Z: np.ascontiguousarray(np.stack([Z.real, Z.imag], axis=1))  # noqa: E731
        return split(Q), split(X)

    @pytest.mark.parametrize("rows", [False, True])
    def test_gram_project_cholqr_match_jax(self, rows):
        Qs, Xs = self._blocks()

        def t(Z):
            if rows:  # views of row storage, as the propagators hand them in
                return torch.as_tensor(np.ascontiguousarray(Z.transpose(2, 1, 0))).permute(2, 1, 0)
            return torch.as_tensor(Z)

        np.testing.assert_allclose(csplit.split_gram(t(Qs), t(Xs)),
                                   jcs.split_gram(jnp.asarray(Qs), jnp.asarray(Xs)),
                                   rtol=0, atol=1e-12)
        for passes in (1, 2):
            Y, R = csplit.split_project(t(Qs), t(Xs), passes=passes)
            Yj, Rj = jcs.split_project(jnp.asarray(Qs), jnp.asarray(Xs), passes=passes)
            assert tuple(Y.shape) == Xs.shape
            np.testing.assert_allclose(_np(Y), np.asarray(Yj), rtol=0, atol=1e-12)
            np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-12)
        Q, R = csplit.split_cholqr(t(Xs))
        Qj, Rj = jcs.split_cholqr(jnp.asarray(Xs))
        np.testing.assert_allclose(_np(Q), np.asarray(Qj), rtol=0, atol=1e-12)
        np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-12)
        G = csplit.split_gram(Q, Q)
        np.testing.assert_allclose(G, np.eye(G.shape[0]), atol=1e-13)

    def test_cholqr_shift_on_breakdown(self):
        """A rank-deficient block takes the shifted Cholesky, as in JAX."""
        _, Xs = self._blocks(p=3, seed=1)
        Xs = np.concatenate([Xs, Xs[:, :, :1]], axis=2)  # repeated column
        Q, R = csplit.split_cholqr(torch.as_tensor(Xs))
        Qj, Rj = jcs.split_cholqr(jnp.asarray(Xs))
        assert np.isfinite(_np(Q)).all()
        np.testing.assert_allclose(R, Rj, rtol=1e-8, atol=1e-8)
