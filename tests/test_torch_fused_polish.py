"""PyTorch port, solvers/fused_restarted.py and solvers/polish.py against
the JAX package on identical inputs (CPU, float64 unless stated).

Subspaces are compared through the singular values of |Q_port^T Q_jax|
(all >= 1 - 1e-8), never column by column: eigh's sign conventions
differ between the frameworks."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ca_lanczos_tpu.ops.spmv import DiaMatrix as JDia
from ca_lanczos_tpu.solvers.fused_restarted import fused_restarted_ca_lanczos as jfused
from ca_lanczos_tpu.solvers.polish import rayleigh_ritz_polish as jpolish
from ca_lanczos_tpu.solvers.polish import rayleigh_ritz_polish_host as jpolish_host
from ca_lanczos_tpu.utils.matrices import diag_spectrum as jdiag_spectrum
from ca_lanczos_tpu_torch.ops.cuda_ilv import IlvDiaMatrix, ilv_encode
from ca_lanczos_tpu_torch.solvers.fused_restarted import fused_restarted_ca_lanczos
from ca_lanczos_tpu_torch.solvers.polish import rayleigh_ritz_polish, rayleigh_ritz_polish_host
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _subspace_cos(Qa, Qb):
    Qa, _ = np.linalg.qr(np.asarray(Qa, np.float64))
    Qb, _ = np.linalg.qr(np.asarray(Qb, np.float64))
    return np.linalg.svd(np.abs(Qa.T @ Qb), compute_uv=False)


def test_fused_matches_jax_on_diag_spectrum():
    # as tests/test_harness.py TestSolveAutoFusedEngine
    n = 400
    Aj = jdiag_spectrum(n, 1.0, 100.0)
    A = operator_from_numpy(Aj, device="cpu")
    kw = dict(n_wanted=6, s=4, tol=1e-8)
    rj = jfused(Aj, jnp.ones(n), 32, **kw)
    rt = fused_restarted_ca_lanczos(A, torch.ones(n, dtype=torch.float64), 32, **kw)
    assert rt.converged and rj.converged and rt.nconv == 6
    exact = np.linspace(1.0, 100.0, n)[::-1][:6]
    np.testing.assert_allclose(np.sort(rt.eigs)[::-1], exact, rtol=1e-9)
    np.testing.assert_allclose(np.sort(rt.eigs)[::-1], np.sort(rj.eigs)[::-1], rtol=1e-9)
    assert rt.Q_conv.shape == (n, 6)
    assert _subspace_cos(rt.Q_conv.numpy(), np.asarray(rj.Q_conv)).min() >= 1 - 1e-8


def _tridiag(n=4096, seed=0):
    d = np.linspace(1.0, 90.0, n)
    d[-5:] = np.linspace(95.0, 100.0, 5)
    off = np.random.default_rng(seed).standard_normal(n - 1) * 1e-3
    return d, off


def test_fused_mixed_precision_f32_and_burst_hook():
    d, off = _tridiag(2000)
    data = np.zeros((3, 2000), np.float32)
    data[0, 1:], data[1], data[2, :-1] = off, d, off
    Aj = JDia(data=jnp.asarray(data), offsets=(-1, 0, 1))
    A = operator_from_numpy(Aj, device="cpu")
    bursts = []
    rt = fused_restarted_ca_lanczos(A, np.ones(2000), 32, n_wanted=3, s=8, tol=1e-5,
                                    mixed_precision=True, cycles_per_call=2,
                                    on_burst=lambda c, k: bursts.append((c, k)))
    assert rt.converged and rt.eigs.dtype == np.float64
    exact = sla.eigh_tridiagonal(d, off, eigvals_only=True)[::-1][:3]
    np.testing.assert_allclose(np.sort(rt.eigs)[::-1], exact, rtol=1e-6)
    assert bursts[-1] == (rt.n_restarts, rt.nconv)
    assert all(c % 2 == 0 for c, _ in bursts[:-1])


def test_fused_on_interleaved_carrier_matches_dia():
    # the K3 path (plain version on CPU) and the DIA path converge to the
    # same values; the carrier solve lives in the interleaved space
    d, off = _tridiag(16384)
    data = np.zeros((3, 16384))
    data[0, 1:], data[1], data[2, :-1] = off, d, off
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

    A = DiaMatrix(data=torch.as_tensor(data), offsets=(-1, 0, 1))
    kw = dict(n_wanted=4, s=8, tol=1e-9)
    r_dia = fused_restarted_ca_lanczos(A, np.ones(16384), 32, **kw)
    r_ilv = fused_restarted_ca_lanczos(IlvDiaMatrix.from_dia(A), ilv_encode(np.ones(16384)),
                                       32, **kw)
    assert r_dia.converged and r_ilv.converged
    np.testing.assert_allclose(np.sort(r_ilv.eigs), np.sort(r_dia.eigs), rtol=1e-10)


def _polish_inputs(k=5, noise=1e-5):
    d, off = _tridiag()
    n = len(d)
    a = sp.diags([off, d, off], [-1, 0, 1], format="csr")
    _, V = spla.eigsh(a, k=k, which="LA")
    X = V + noise * np.random.default_rng(1).standard_normal(V.shape)
    data = np.zeros((3, n))
    data[0, 1:], data[1], data[2, :-1] = off, d, off
    exact = sla.eigh_tridiagonal(d, off, eigvals_only=True)[::-1][:k]
    return a, JDia(data=jnp.asarray(data), offsets=(-1, 0, 1)), X, exact


def test_device_polish_matches_jax():
    _, Aj, X, exact = _polish_inputs()
    wj, rj, Qj = jpolish(Aj, jnp.asarray(X, jnp.float32), iters=3, depth=4)
    w, r, Q = rayleigh_ritz_polish(operator_from_numpy(Aj, device="cpu"), torch.as_tensor(X),
                                   iters=3, depth=4)
    np.testing.assert_allclose(w, np.asarray(wj), rtol=1e-10)
    np.testing.assert_allclose(np.sort(w)[::-1], exact, rtol=1e-10)
    assert np.all(r <= 10 * np.asarray(rj) + 1e-12) and np.all(np.asarray(rj) <= 10 * r + 1e-12)
    assert Q.dtype == torch.float32 and Q.shape == X.shape
    assert _subspace_cos(Q.numpy(), np.asarray(Qj)).min() >= 1 - 1e-8


def test_host_polish_matches_jax():
    a, _, X, exact = _polish_inputs(k=4)
    wj, rj, Qj = jpolish_host(lambda Z: a @ Z, X, iters=3, depth=4)
    w, r, Q = rayleigh_ritz_polish_host(lambda Z: a @ Z, torch.as_tensor(X), iters=3, depth=4)
    np.testing.assert_allclose(w, wj, rtol=1e-10)
    np.testing.assert_allclose(np.sort(w)[::-1], exact, rtol=1e-10)
    assert np.all(r <= 10 * rj + 1e-12) and np.all(rj <= 10 * r + 1e-12)
    assert _subspace_cos(Q, Qj).min() >= 1 - 1e-8


def test_polish_rejects_f32_planes():
    _, Aj, X, _ = _polish_inputs(k=2)
    A = operator_from_numpy(Aj, device="cpu")
    A32 = type(A)(data=A.data.float(), offsets=A.offsets)
    with pytest.raises(ValueError, match="f64"):
        rayleigh_ritz_polish(A32, torch.as_tensor(X))
