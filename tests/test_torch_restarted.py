"""PyTorch port, solvers/restarted.py (``restarted_lanczos`` and the
flagship ``restarted_ca_lanczos``) against the JAX package on identical
numpy inputs, float64 (mirrors tests/test_restarted.py): the diagonal
fixture over every orth mode (and both bases for the CA driver), the
flagship configuration, the 2-D Laplacian, the four restart strategies at
both spectrum ends, one case each on an interleaved (IlvDiaMatrix) and a
PELL operator, and checkpoint interchange between the packages.

Tolerances: eigenvalues rtol 1e-10, the restart count equal, locked
vectors 1e-8 up to sign.  The interleaved and PELL cases run the JAX
driver on the same matrix as a DiaMatrix / EllMatrix (the JAX package
would run its Pallas kernels in interpret mode, minutes at these sizes);
their eigenvalues and restart counts are held to the same limits."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ca_lanczos_tpu.config import Basis as JBasis
from ca_lanczos_tpu.config import LanczosConfig as JConfig
from ca_lanczos_tpu.config import Orth as JOrth
from ca_lanczos_tpu.config import RestartStrategy as JStrategy
from ca_lanczos_tpu.ops.spmv import DiaMatrix as JDia
from ca_lanczos_tpu.ops.spmv import EllMatrix as JEll
from ca_lanczos_tpu.solvers.restarted import restarted_ca_lanczos as jrca
from ca_lanczos_tpu.solvers.restarted import restarted_lanczos as jrl
from ca_lanczos_tpu.utils.matrices import diag_spectrum as jdiag
from ca_lanczos_tpu.utils.matrices import laplacian_2d as jlap2
from ca_lanczos_tpu_torch.config import Basis, LanczosConfig, Orth, RestartStrategy
from ca_lanczos_tpu_torch.ops.cuda_ilv import IlvDiaMatrix, ilv_encode
from ca_lanczos_tpu_torch.ops.pell import PellMatrix
from ca_lanczos_tpu_torch.solvers import restarted
from ca_lanczos_tpu_torch.solvers.restarted import restarted_ca_lanczos, restarted_lanczos
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy

ORTHS = ["local", "full", "periodic", "selective"]


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


def _diag_from(d):
    return _pair(JDia(data=jnp.asarray(np.asarray(d, np.float64))[None, :], offsets=(0,)))


def _ones(n):
    return torch.ones(n, dtype=torch.float64)


def _same(rt, rj, vectors=1e-8, rtol=1e-10):
    assert rt.converged and rj.converged
    assert rt.n_restarts == rj.n_restarts
    np.testing.assert_allclose(rt.eigs, rj.eigs, rtol=rtol)
    if vectors is not None:
        Qt, Qj = rt.Q_conv.numpy(), np.asarray(rj.Q_conv)
        assert Qt.shape == Qj.shape
        signs = np.sign(np.sum(Qt * Qj, axis=0))
        np.testing.assert_allclose(Qt * signs, Qj, rtol=0, atol=vectors)


def _cfgs(**kw):
    enums = {"basis": (Basis, JBasis), "orth": (Orth, JOrth),
             "restart_strategy": (RestartStrategy, JStrategy)}
    t = {k: enums[k][0](v) if k in enums else v for k, v in kw.items()}
    j = {k: enums[k][1](v) if k in enums else v for k, v in kw.items()}
    return LanczosConfig(**t), JConfig(**j)


@pytest.mark.parametrize("orth", ORTHS)
def test_restarted_lanczos_diagonal_matches_jax(orth):
    Aj, A = _pair(jdiag(400, 1.0, 100.0))
    kw = dict(max_lanczos=30, n_wanted=6, tol=1e-8)
    rj = jrl(Aj, jnp.ones(400), orth=JOrth(orth), **kw)
    rt = restarted_lanczos(A, _ones(400), orth=Orth(orth), **kw)
    _same(rt, rj)
    np.testing.assert_allclose(rt.eigs, np.linspace(1.0, 100.0, 400)[::-1][:6], rtol=1e-6)
    assert rt.orth_err.shape == (rt.n_restarts,)


@pytest.mark.parametrize("orth", ORTHS)
@pytest.mark.parametrize("basis", ["monomial", "newton"])
def test_restarted_ca_lanczos_diagonal_matches_jax(orth, basis):
    Aj, A = _pair(jdiag(400, 1.0, 100.0))
    ct, cj = _cfgs(s=4, basis=basis, orth=orth, n_wanted=6, tol=1e-8)
    rj = jrca(Aj, jnp.ones(400), 32, cj)
    rt = restarted_ca_lanczos(A, _ones(400), 32, ct)
    _same(rt, rj)
    np.testing.assert_allclose(rt.eigs, np.linspace(1.0, 100.0, 400)[::-1][:6], rtol=1e-6)
    assert rt.rnorms.shape == (rt.n_restarts, 6) and rt.orth_err.shape == (rt.n_restarts,)


def test_flagship_config_matches_jax():
    # north-star defaults: s=6, Newton, local, n_wanted=10, tol=1e-8
    Aj, A = _pair(jdiag(500, 1.0, 100.0))
    rj = jrca(Aj, jnp.ones(500), 60, JConfig())
    rt = restarted_ca_lanczos(A, _ones(500), 60, LanczosConfig())
    # local orth over 60-vector cycles: the locked vectors are defined only
    # to ~|r|/gap = 1e-6/0.198 (tol 1e-8 * |A|, spacing 0.198), and the
    # packages' last bits grow to ~1e-7 there; the other fixtures hold 1e-8
    _same(rt, rj, vectors=1e-6)
    assert np.max(rt.conv_rnorms) < 1e-8 * 100.0 * 1.01


def test_laplacian_2d_matches_jax():
    Aj, A = _pair(jlap2(20, 20))
    r = np.random.default_rng(3).standard_normal(400)
    ct, cj = _cfgs(s=4, basis="newton", orth="full", n_wanted=4, tol=1e-9)
    rj = jrca(Aj, jnp.asarray(r), 40, cj)
    rt = restarted_ca_lanczos(A, torch.as_tensor(r), 40, ct)
    _same(rt, rj)
    lam = 2 - 2 * np.cos(np.pi * np.arange(1, 21) / 21)
    exact = np.sort(np.add.outer(lam, lam).ravel())[::-1][:4]
    np.testing.assert_allclose(rt.eigs, exact, rtol=1e-7)


@pytest.mark.parametrize("strategy", ["largest", "smallest", "closest_conv", "random"])
def test_restart_strategies_match_jax(strategy):
    # the RANDOM strategy draws from numpy default_rng(config.seed) in both
    Aj, A = _pair(jdiag(300, 1.0, 60.0))
    ct, cj = _cfgs(s=4, basis="newton", orth="full", n_wanted=4, tol=1e-8,
                   restart_strategy=strategy, max_restarts=30)
    rj = jrca(Aj, jnp.ones(300), 32, cj)
    rt = restarted_ca_lanczos(A, _ones(300), 32, ct)
    assert rt.converged == rj.converged and rt.n_restarts == rj.n_restarts
    np.testing.assert_allclose(rt.eigs, rj.eigs, rtol=1e-10)
    d = np.linspace(1.0, 60.0, 300)
    for lam in rt.eigs:
        assert np.min(np.abs(d - lam)) < 1e-6 * 60.0


def _two_ended(n, top):
    """tests/test_restarted.py TestWantedEndStop / TestSmallestEnd: a
    separated end that converges first and a tight cluster at the other.
    On the bottom cluster the CA driver locks its fourth member with an
    estimate of ~1e-10 taken from a nearly invariant Krylov space, where
    last bits decide the value to ~1e-9 in both packages (at any tol from
    1e-7 to 1e-10): that case holds the eigenvalues at rtol 1e-8 and the
    vectors at the solve's own accuracy, every other at 1e-10 / 1e-8."""
    d = np.linspace(0.0, 1.0, n)
    if top:
        d[:3] = [-6.0, -5.0, -4.0]
        d[-6:] = 1.0 + np.arange(6) * 1e-3
    else:
        d[-3:] = [4.0, 5.0, 6.0]
        d[:6] = -1.0 - np.arange(6) * 1e-3
    return d


@pytest.mark.parametrize("driver", ["ca", "std"])
@pytest.mark.parametrize("end", ["largest", "smallest"])
def test_wanted_end_matches_jax(driver, end):
    d = _two_ended(3000, top=end == "largest")
    Aj, A = _diag_from(d)
    if driver == "ca":
        ct, cj = _cfgs(n_wanted=4, s=4, tol=1e-7, max_restarts=200, orth="full",
                       restart_strategy=end)
        rj = jrca(Aj, jnp.ones(3000), 24, cj)
        rt = restarted_ca_lanczos(A, _ones(3000), 24, ct)
    else:
        kw = dict(n_wanted=4, tol=1e-7, max_restarts=200)
        rj = jrl(Aj, jnp.ones(3000), 24, orth=JOrth.FULL, restart_strategy=JStrategy(end), **kw)
        rt = restarted_lanczos(A, _ones(3000), 24, orth=Orth.FULL,
                               restart_strategy=RestartStrategy(end), **kw)
    if driver == "ca" and end == "smallest":
        _same(rt, rj, vectors=1e-5, rtol=1e-8)
    else:
        _same(rt, rj)
    exact = np.sort(d)[::-1][:4] if end == "largest" else np.sort(d)[:4]
    np.testing.assert_allclose(rt.eigs, exact, atol=1e-7)


def _band(n):
    """The two-stage fixture of tests/test_harness.py (a planted top over a
    tridiagonal with 1e-3 couplings), as scipy CSR."""
    d = np.linspace(1.0, 90.0, n)
    d[-5:] = np.linspace(95.0, 100.0, 5)
    off = np.random.default_rng(0).standard_normal(n - 1) * 1e-3
    return sp.diags([off, d, off], [-1, 0, 1], format="csr")


def _jax_ell(a):
    from ca_lanczos_tpu_torch.ops.spmv import EllMatrix

    e = EllMatrix.from_scipy(a, device="cpu")
    return JEll(vals=jnp.asarray(e.vals.numpy()), cols=jnp.asarray(e.cols.numpy(), jnp.int32))


@pytest.mark.parametrize("fmt", ["ilv", "pell"])
def test_interleaved_and_pell_operators_match_jax(fmt):
    n = 4096
    a = _band(n)
    ct, cj = _cfgs(s=4, n_wanted=4, tol=1e-8)
    rj = jrca(_jax_ell(a), jnp.ones(n), 32, cj)
    if fmt == "ilv":
        from ca_lanczos_tpu_torch.ops.formats import dia_from_scipy

        A = IlvDiaMatrix.from_dia(dia_from_scipy(a, device="cpu"))
        r = torch.as_tensor(ilv_encode(np.ones(n)))
    else:
        A = PellMatrix.from_scipy(a, tile=512, encoding="auto", device="cpu")
        r = _ones(n)
    rt = restarted_ca_lanczos(A, r, 32, ct)
    _same(rt, rj, vectors=None)


def test_checkpoint_interchange_with_jax(tmp_path):
    # interrupt after 3 restarts, resume in the other package: the same
    # result as one uninterrupted run
    Aj, A = _pair(jdiag(400, 1.0, 100.0))
    full_t, _ = _cfgs(s=4, n_wanted=6, tol=1e-8)
    cut_t, cut_j = _cfgs(s=4, n_wanted=6, tol=1e-8, max_restarts=3)
    whole = restarted_ca_lanczos(A, _ones(400), 32, full_t)
    p_t, p_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    part = restarted_ca_lanczos(A, _ones(400), 32, cut_t, checkpoint_path=p_t)
    assert part.n_restarts == 3 and not part.converged
    jrca(Aj, jnp.ones(400), 32, cut_j, checkpoint_path=p_j)
    _, full_j = _cfgs(s=4, n_wanted=6, tol=1e-8)
    by_jax = jrca(Aj, jnp.ones(400), 32, full_j, resume_from=p_t)
    by_port = restarted_ca_lanczos(A, _ones(400), 32, full_t, resume_from=p_j)
    for res in (by_jax, by_port):
        assert res.converged and res.n_restarts == whole.n_restarts
        np.testing.assert_allclose(res.eigs, whole.eigs, rtol=1e-10)


def test_verify_floor_reads_torch_dtypes():
    assert restarted._verify_floor(torch.float32, 1e-9) == 1e-3
    assert restarted._verify_floor(torch.float64, 1e-9) == pytest.approx(1e-7)
    assert restarted._verify_floor(torch.float64, 1e-12) == 1e-7
    assert restarted._verify_floor(torch.float64, 1e-4) == pytest.approx(1e-2)
    assert restarted._verify_floor(torch.float32, 1e-9, safe_qr=True) == 1e-2


def test_f32_state_takes_the_f32_floor():
    # an f32 run on the card's dtype path (the plain versions here) locks
    # the top of the spectrum with the 1e-3 gate floor
    A = operator_from_numpy(jdiag(400, 1.0, 100.0), device="cpu")
    A32 = type(A)(data=A.data.float(), offsets=A.offsets)
    cfg = LanczosConfig(s=4, n_wanted=4, tol=1e-5)
    res = restarted_ca_lanczos(A32, torch.ones(400), 32, cfg)
    assert res.converged and res.Q_conv.dtype == torch.float32
    np.testing.assert_allclose(res.eigs, np.linspace(1.0, 100.0, 400)[::-1][:4], rtol=1e-5)
