"""PyTorch port, solvers/sstep.py against the JAX package on identical
numpy inputs (float64/complex128, ``device="cpu"``); mirrors
tests/test_sstep.py.

Tolerances: T and Q against the JAX package 1e-9 relative to their max
(the unorthogonalized basis amplifies reduction-order roundoff through the
W solves: 2e-11 at (s, m) = (4, 3)); Ritz values against full-orth Lanczos
1e-5 (the JAX test's bound); the Krylov-span residual 1e-8; the
``sstep_lanczos_prop`` residual estimate against JAX's rtol 1e-6 where it
lies above roundoff (at the JAX test's (3, 4) it is ~3e-15, noise, so
there only its bound is checked)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ca_lanczos_tpu.solvers import sstep as js
from ca_lanczos_tpu.utils.matrices import diag_spectrum as jdiag
from ca_lanczos_tpu.utils.matrices import gaussian_packet as jpacket
from ca_lanczos_tpu.utils.matrices import harmonic_oscillator as jho
from ca_lanczos_tpu.utils.matrices import laplacian_1d as jlap
from ca_lanczos_tpu_torch.solvers import sstep as ts
from ca_lanczos_tpu_torch.solvers.lanczos import lanczos
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("s,m", [(2, 4), (3, 3), (4, 3)])
def test_sstep_matches_jax_and_lanczos(s, m):
    n = 200
    Aj = jlap(n)
    A = operator_from_numpy(Aj, device="cpu")
    r = np.random.default_rng(0).standard_normal(n)
    rj = js.sstep_lanczos(Aj, jnp.asarray(r), s, m)
    rt = ts.sstep_lanczos(A, torch.as_tensor(r), s, m)
    assert rt.T.shape == (s * m, s * m) and tuple(rt.Q.shape) == (n, s * m)
    assert _rel(rt.T, rj.T) <= 1e-9
    assert _rel(rt.Q.numpy(), rj.Q) <= 1e-9
    ref = lanczos(A, torch.as_tensor(r), s * m, orth="full")
    d_s = np.sort(np.linalg.eigvals(rt.T).real)
    np.testing.assert_allclose(d_s, np.sort(np.linalg.eigvalsh(ref.T)), rtol=1e-5, atol=1e-5)


def test_basis_spans_krylov():
    n, s, m = 100, 2, 3
    A = operator_from_numpy(jdiag(n, 1.0, 10.0), device="cpu")
    r = np.random.default_rng(1).standard_normal(n)
    res = ts.sstep_lanczos(A, torch.as_tensor(r), s, m)
    K = [r / np.linalg.norm(r)]
    Ad = A.to_dense().numpy()
    for _ in range(s * m - 1):
        K.append(Ad @ K[-1])
    Kq, _ = np.linalg.qr(np.stack(K, axis=1))
    Q = res.Q.numpy()
    assert np.max(np.abs(Q - Kq @ (Kq.T @ Q))) / np.max(np.abs(Q)) < 1e-8


@pytest.mark.parametrize("s,m", [(3, 2), (2, 3), (3, 4)])
def test_sstep_prop_matches_jax(s, m):
    Hj, x = jho(128, (-10.0, 10.0))
    H = operator_from_numpy(Hj, device="cpu")
    psi = jpacket(x).astype(np.complex128)
    rj = js.sstep_lanczos_prop(Hj, jnp.asarray(psi), s=s, m=m, dt=0.025)
    rt = ts.sstep_lanczos_prop(H, torch.as_tensor(psi), s=s, m=m, dt=0.025)
    assert rt.T.shape == (s * m, s * m) and rt.Q.dtype == torch.complex128
    assert _rel(rt.T, rj.T) <= 1e-9
    assert np.isfinite(rt.residual) and rt.residual < 1e-6
    if rj.residual > 1e-12:
        np.testing.assert_allclose(rt.residual, rj.residual, rtol=1e-6)
    # a real start vector is taken as complex128, as in JAX
    rr = ts.sstep_lanczos_prop(H, torch.as_tensor(psi.real), s=s, m=m, dt=0.025)
    assert rr.Q.dtype == torch.complex128
    np.testing.assert_allclose(rr.T, rt.T, rtol=0, atol=1e-12 * np.abs(rt.T).max())


class _CountingOps(ts._LocalOps):
    """The default operations, counted: the seam a distributed driver
    plugs into."""

    def __init__(self, H):
        super().__init__(H)
        self.calls = {"powers": 0, "dots": 0, "next_p1": 0, "basis_update": 0}

    def powers(self, p1, s):
        self.calls["powers"] += 1
        return super().powers(p1, s)

    def dots(self, P):
        self.calls["dots"] += 1
        return super().dots(P)

    def next_p1(self, Vk, Vkm1, Es, Gs):
        self.calls["next_p1"] += 1
        return super().next_p1(Vk, Vkm1, Es, Gs)

    def basis_update(self, P, Vk, t):
        self.calls["basis_update"] += 1
        return super().basis_update(P, Vk, t)


def test_ops_seam_is_used():
    n, s, m = 200, 3, 3
    Aj = jlap(n)
    A = operator_from_numpy(Aj, device="cpu")
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(n))
    ops = _CountingOps(A)
    got = ts.sstep_lanczos(A, r, s, m, ops=ops)
    assert ops.calls == {"powers": m, "dots": m, "next_p1": m, "basis_update": m - 1}
    np.testing.assert_array_equal(got.T, ts.sstep_lanczos(A, r, s, m).T)
    np.testing.assert_allclose(got.T, js.sstep_lanczos(Aj, jnp.asarray(r.numpy()), s, m).T,
                               rtol=0, atol=1e-9 * np.abs(got.T).max())
