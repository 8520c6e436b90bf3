"""PyTorch port, the slices as a whole: ``solve_auto`` (route -> probe ->
solve -> f64 polish) against the JAX package on the two-stage operator of
tests/test_harness.py TestTwoStagePolish (fused and host engines) and on a
small general-sparsity (PELL-routed) operator, the host escalation ladder
on tests/test_harness.py's fast-path and escalation cases and with the IRL
as first rung (chip_smoke.py phase F's recipe), ``make_operator``'s
interleaved and PELL routes, the entry points' CUDA default, and the
package's independence from JAX.

Eigenvalues: rtol 1e-10 against JAX and against the exact eigenvalues of
the matrix the polish sees (the f32-rounded one for f32 input); the
smallest end is 1e-7 against the exact values (see its test)."""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ca_lanczos_tpu.config import LanczosConfig as JConfig
from ca_lanczos_tpu.config import Orth as JOrth
from ca_lanczos_tpu.harness.auto import solve_auto as jsolve_auto
from ca_lanczos_tpu.ops.formats import make_operator as jmake_operator
from ca_lanczos_tpu_torch.config import LanczosConfig, Orth
from ca_lanczos_tpu_torch.harness.auto import solve_auto
from ca_lanczos_tpu_torch.ops.cuda_ilv import IlvDiaMatrix
from ca_lanczos_tpu_torch.ops.formats import make_operator
from ca_lanczos_tpu_torch.ops.pell import PellMatrix
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy
from tests.test_torch_pell import pin_encoder


@pytest.fixture(autouse=True, scope="module")
def _jax_native_encoder():
    """JAX's PELL encoder on its native path, as the port's (``pin_encoder``):
    the PELL route's planes and f32 sums are then the same in both
    packages."""
    with pytest.MonkeyPatch.context() as mp:
        pin_encoder(mp, "native")
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _op(n=4096):
    d = np.linspace(1.0, 90.0, n)
    d[-5:] = np.linspace(95.0, 100.0, 5)
    off = np.random.default_rng(0).standard_normal(n - 1) * 1e-3
    return sp.diags([off, d, off], [-1, 0, 1], format="csr")


def _exact(a):
    """Eigenvalues (ascending) of the matrix as the f64 polish sees it."""
    a64 = a.astype(np.float64)
    return sla.eigh_tridiagonal(a64.diagonal(0), a64.diagonal(1), eigvals_only=True)


@pytest.mark.parametrize("dtype,prefer", [
    (np.float64, "dia"), (np.float64, "auto"), (np.float32, "dia"), (np.float32, "auto"),
])
def test_solve_auto_matches_jax(dtype, prefer):
    a = _op().astype(dtype)
    r = np.random.default_rng(1).standard_normal(a.shape[0])
    kw = dict(engine="fused", polish=6, over_lock=3, prefer=prefer)
    cfg = dict(n_wanted=5, s=8, tol=1e-4, max_restarts=100)
    rj = jsolve_auto(a, r, 32, JConfig(**cfg), **kw)
    rt = solve_auto(a, r, 32, LanczosConfig(**cfg), **kw, device="cpu")
    assert rt.converged and rt.solver == rj.solver == "restarted_ca_lanczos+polish6"
    assert rt.route.format == rj.route.format == "dia"
    assert rt.route.perm is None and rj.route.perm is None
    assert not rt.escalated
    got = np.sort(rt.eigs)[::-1]
    np.testing.assert_allclose(got, np.sort(rj.eigs)[::-1], rtol=1e-10)
    np.testing.assert_allclose(got, _exact(a)[::-1][:5], rtol=1e-10)
    assert rt.Q_conv.shape == (a.shape[0], 5) and rt.polish_resid.shape == (5,)
    assert set(rt.stage_seconds) == {"route", "probe", "solve", "polish"}


def test_solve_auto_smallest_matches_jax():
    # TestTwoStagePolish.test_polish_smallest_end's configuration.  The
    # bottom-end gaps are ~2e-2 on values ~1, so six polish passes land
    # 1e-8-grade against the exact values in BOTH packages (the JAX test
    # asserts 1e-7); the two packages agree to 1e-10.
    a = _op()
    r = np.random.default_rng(2).standard_normal(a.shape[0])
    kw = dict(engine="fused", polish=6, over_lock=2, which="smallest")
    cfg = dict(n_wanted=3, s=4, tol=1e-5, max_restarts=100)
    rj = jsolve_auto(a, r, 32, JConfig(**cfg), **kw)
    rt = solve_auto(a, r, 32, LanczosConfig(**cfg), **kw, device="cpu")
    assert rt.converged and rt.solver == rj.solver and rt.route.format == rj.route.format
    got = np.sort(rt.eigs)
    np.testing.assert_allclose(got, np.sort(rj.eigs), rtol=1e-10)
    np.testing.assert_allclose(got, _exact(a)[:3], rtol=1e-7)


@pytest.mark.parametrize("n,prefer", [(16384, "ilv"), (10000, "ilv"), (16384, "auto")])
def test_interleaved_route_matches_jax(n, prefer):
    a = _op(n).astype(np.float32)
    Aj, rj = jmake_operator(a, prefer=prefer, ilv=True)
    At, rt = make_operator(a, prefer=prefer, ilv=True, device="cpu")
    assert rt.format == rj.format == "ilv"
    assert rt.n_orig == rj.n_orig == n
    np.testing.assert_array_equal(rt.perm, rj.perm)
    assert isinstance(At, IlvDiaMatrix)
    ref = operator_from_numpy(Aj, device="cpu")
    torch.testing.assert_close(At.data_il, ref.data_il, rtol=0, atol=0)
    torch.testing.assert_close(At.dia_data, ref.dia_data, rtol=0, atol=0)
    # apply/restore: numpy and tensors agree and invert each other
    x = np.random.default_rng(2).standard_normal(n)
    xe = rt.apply(x)
    np.testing.assert_array_equal(rt.apply(torch.as_tensor(x)).numpy(), xe)
    np.testing.assert_array_equal(rt.restore(xe), x)
    np.testing.assert_array_equal(rt.restore(torch.as_tensor(xe)).numpy(), x)


def test_auto_route_on_cpu_stays_dia_like_jax():
    a = _op(16384).astype(np.float32)
    _, rj = jmake_operator(a)
    _, rt = make_operator(a, device="cpu")
    assert rt.format == rj.format == "dia"


def test_permuted_route_polishes_on_host():
    # forced interleave: the polish takes the host branch, as in JAX
    a = _op(16384)
    r = np.random.default_rng(3).standard_normal(16384)
    res = solve_auto(a, r, 32, LanczosConfig(n_wanted=3, s=8, tol=1e-6, max_restarts=100),
                     engine="fused", polish=4, over_lock=2, prefer="ilv", device="cpu")
    assert res.route.format == "ilv" and res.converged
    np.testing.assert_allclose(np.sort(res.eigs)[::-1], _exact(a)[::-1][:3], rtol=1e-10)
    assert res.Q_conv.shape == (16384, 3)


def _diag_op(vals):
    from ca_lanczos_tpu.ops.spmv import DiaMatrix as JDia

    Aj = JDia(data=jnp.asarray(np.asarray(vals, np.float64))[None, :], offsets=(0,))
    return Aj, operator_from_numpy(Aj, device="cpu")


@pytest.mark.parametrize("case", ["fast_path", "escalates"])
def test_solve_auto_host_engine_matches_jax(case):
    # tests/test_harness.py's fast-path and escalation cases at solve_auto's
    # default engine ("host"): the explicit driver converges first on a
    # separated top; on a cluster just below the probe's resolution the
    # probe routes it to the explicit driver, which stalls, and the ladder
    # converges it at the same budget
    n = 400
    if case == "fast_path":
        vals = np.linspace(1.0, 100.0, n)
        r = np.random.default_rng(1).random(n)
        cfg, m = dict(s=4, n_wanted=4, tol=1e-9), 32
    else:
        vals = np.concatenate([np.linspace(1.0, 50.0, n - 4), 100.0 + 2e-4 * np.arange(4)])
        r = np.random.default_rng(0).random(n)
        cfg, m = dict(s=4, n_wanted=4, orth=Orth.FULL, tol=1e-9, max_restarts=60), 24
    Aj, A = _diag_op(vals)
    jcfg = dict(cfg, orth=JOrth(cfg["orth"].value)) if "orth" in cfg else cfg
    rj = jsolve_auto(Aj, jnp.asarray(r), m, JConfig(**jcfg))
    rt = solve_auto(A, r, m, LanczosConfig(**cfg), device="cpu")
    assert rt.converged and rj.converged
    assert (rt.solver, rt.escalated, rt.n_restarts) == (rj.solver, rj.escalated, rj.n_restarts)
    if case == "fast_path":
        assert rt.solver == "restarted_ca_lanczos" and not rt.escalated
    np.testing.assert_allclose(rt.eigs, np.asarray(rj.eigs), rtol=1e-10)
    np.testing.assert_allclose(np.sort(rt.eigs)[::-1][:4], np.sort(vals)[::-1][:4], rtol=1e-8)


def _cluster_op(n):
    """chip_smoke.py phase F's recipe (see there) at a small n: a planted
    top cluster of 10 spaced 0.01 that decouples exactly."""
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = 99.0 + 0.01 * np.arange(10)
    off = np.random.default_rng(0).standard_normal(n) * 1e-3
    off[n - 11:] = 0.0
    return sp.diags([off[:-1], d, off[:-1]], [-1, 0, 1], format="csr"), d[-10:][::-1]


def test_solve_auto_irl_first_rung_matches_jax():
    # the probe finds the cluster, so the IRL is the first rung
    a, exact = _cluster_op(4096)
    r = np.ones(4096)
    kw = dict(polish=10, over_lock=3, prefer="dia")
    cfg = dict(n_wanted=10, s=8, tol=1e-4, max_restarts=200)
    rj = jsolve_auto(a, r, 48, JConfig(**cfg), **kw)
    rt = solve_auto(a, r, 48, LanczosConfig(**cfg), **kw, device="cpu")
    assert rt.solver == rj.solver == "impl_restarted_ca_lanczos+polish10"
    assert rt.converged and not rt.escalated and not rj.escalated
    assert rt.n_restarts == rj.n_restarts
    got = np.sort(rt.eigs)[::-1]
    np.testing.assert_allclose(got, np.sort(rj.eigs)[::-1], rtol=1e-10)
    np.testing.assert_allclose(got, exact, rtol=1e-10)
    assert rt.Q_conv.shape == (4096, 10) and bool(torch.isfinite(rt.Q_conv).all())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_auto_host_flagship_matches_jax(dtype):
    # chip_smoke.py phase E's settings on the two-stage operator
    a = _op().astype(dtype)
    r = np.random.default_rng(1).standard_normal(a.shape[0])
    kw = dict(polish=6, over_lock=3, prefer="dia")
    cfg = dict(n_wanted=5, s=8, tol=1e-4, max_restarts=100)
    rj = jsolve_auto(a, r, 32, JConfig(**cfg), **kw)
    rt = solve_auto(a, r, 32, LanczosConfig(**cfg), **kw, device="cpu")
    assert rt.converged and rt.solver == rj.solver == "restarted_ca_lanczos+polish6"
    assert not rt.escalated
    if dtype == np.float64:
        assert rt.n_restarts == rj.n_restarts
    got = np.sort(rt.eigs)[::-1]
    np.testing.assert_allclose(got, np.sort(rj.eigs)[::-1], rtol=1e-10)
    np.testing.assert_allclose(got, _exact(a)[::-1][:5], rtol=1e-10)


def _pell_op(n, bw=8, k=4, seed=0):
    """exp/pell_10m_e2e.py's operator (random columns inside a width-8
    band, a separated top) at a small n."""
    rng = np.random.default_rng(seed)
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = np.linspace(95.0, 100.0, 10)
    rows = np.repeat(np.arange(n), k)
    pick = np.argsort(rng.random((n, 2 * bw + 1)), axis=1)[:, :k]
    cols = np.clip(np.arange(n)[:, None] + (pick - bw), 0, n - 1).ravel()
    off = sp.csr_matrix(((rng.standard_normal(n * k) * 1e-3).ravel(), (rows, cols)), (n, n))
    a = off + off.T + sp.diags(d)
    a.sum_duplicates()
    return a.tocsr()


def test_solve_auto_pell_matches_jax():
    # the PELL main path: forced pell route, K5 (grouped) powers, device
    # DIA polish (17 distinct diagonals, as at 11M rows)
    a = _pell_op(4096).astype(np.float32)
    r = np.random.default_rng(1).standard_normal(a.shape[0])
    kw = dict(engine="fused", polish=4, over_lock=3, prefer="pell", tile=512, encoding="auto")
    cfg = dict(n_wanted=5, s=8, tol=1e-4, max_restarts=100)
    rj = jsolve_auto(a, r, 32, JConfig(**cfg), **kw)
    rt = solve_auto(a, r, 32, LanczosConfig(**cfg), **kw, device="cpu")
    assert rt.converged and rt.solver == rj.solver == "restarted_ca_lanczos+polish4"
    assert rt.route.format == rj.route.format == "pell" and rt.route.perm is None
    got = np.sort(rt.eigs)[::-1]
    np.testing.assert_allclose(got, np.sort(rj.eigs)[::-1], rtol=1e-10)
    exact = np.sort(spla.eigsh(a.astype(np.float64), k=5, which="LA",
                               return_eigenvectors=False))[::-1]
    np.testing.assert_allclose(got, exact, rtol=1e-10)
    assert rt.Q_conv.shape == (a.shape[0], 5) and bool(torch.isfinite(rt.Q_conv).all())


def test_pell_rung_raises():
    # the PELL rung's encoder raises on window overflow: forced, the error
    # reaches the caller (as in JAX); routed, the matrix moves on
    rng = np.random.default_rng(4)
    a = sp.random(3000, 3000, density=0.002, random_state=rng, format="csr")
    a = (a + a.T + sp.eye(3000)).tocsr()
    kw = dict(prefer="pell", sw=1024, max_windows=1)
    with pytest.raises(ValueError, match="window overflow") as ej:
        jmake_operator(a, **kw)
    with pytest.raises(ValueError, match="window overflow") as et:
        make_operator(a, **kw, device="cpu")
    assert str(et.value) == str(ej.value)
    At, rt = make_operator(a, device="cpu")
    _, rj = jmake_operator(a)
    assert rt.format == rj.format == "pell" and isinstance(At, PellMatrix)
    A, route = make_operator(a, prefer="ell", device="cpu")
    assert route.format == "ell"
    x = np.random.default_rng(5).standard_normal(3000)
    np.testing.assert_allclose(A.matvec(torch.as_tensor(x)).numpy(), a @ x, rtol=1e-12)


@pytest.mark.parametrize("kind", ["shuffled_band", "expander"])
def test_rcm_retry_and_ell_fallback_match_jax(kind):
    # max_windows=2 makes the PELL window plan reject at a small n, as
    # max_windows=16 does for scattered matrices of ~0.6M+ rows
    n = 100_000
    rng = np.random.default_rng(6)
    if kind == "shuffled_band":
        p = rng.permutation(n)
        a = _op(n)[p][:, p].tocsr()
    else:
        rows = np.repeat(np.arange(n), 3)
        b = sp.csr_matrix((rng.standard_normal(rows.size),
                           (rows, rng.integers(0, n, rows.size))), (n, n))
        a = (b + b.T + sp.eye(n)).tocsr()
    Aj, rj = jmake_operator(a, max_windows=2)
    At, rt = make_operator(a, max_windows=2, device="cpu")
    assert rt.format == rj.format == ("dia" if kind == "shuffled_band" else "ell")
    np.testing.assert_array_equal(rt.perm, rj.perm)
    assert (rt.bandwidth_before, rt.bandwidth_after) == (rj.bandwidth_before,
                                                         rj.bandwidth_after)
    assert [m.split(";")[0] for m in rt.notes[:2]] == [m.split(";")[0] for m in rj.notes[:2]]
    x = rng.standard_normal(n)
    y = rt.restore(At.matvec(torch.as_tensor(rt.apply(x))).numpy())
    np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)
    if kind == "expander":
        with pytest.raises(ValueError, match="fallbacks are disabled"):
            make_operator(a, max_windows=2, allow_ell_fallback=False, device="cpu")


def test_polish_needs_f64_source():
    from ca_lanczos_tpu_torch.ops.spmv import EllMatrix

    A = EllMatrix.from_scipy(_op(512).astype(np.float32), device="cpu")
    with pytest.raises(ValueError, match="f64 operator source"):
        solve_auto(A, np.ones(512), 32, LanczosConfig(n_wanted=3), polish=2, device="cpu")


def _entry_points():
    from ca_lanczos_tpu_torch.ops import formats
    from ca_lanczos_tpu_torch.utils import matrices

    # the ops package exports the function spmv, which hides the module
    spmv = importlib.import_module("ca_lanczos_tpu_torch.ops.spmv")

    band = _op(3000)
    return {
        "make_operator": lambda: make_operator(band),
        "make_operator_pell": lambda: make_operator(band, prefer="pell"),
        "solve_auto": lambda: solve_auto(band, np.ones(3000), 32, LanczosConfig(n_wanted=3),
                                         engine="fused"),
        "solve_auto_host": lambda: solve_auto(band, np.ones(3000), 32, LanczosConfig(n_wanted=3)),
        "dia_from_scipy": lambda: formats.dia_from_scipy(band),
        "PellMatrix.from_scipy": lambda: PellMatrix.from_scipy(band),
        "EllMatrix.from_scipy": lambda: spmv.EllMatrix.from_scipy(band),
        "EllMatrix.from_dense": lambda: spmv.EllMatrix.from_dense(np.eye(4)),
        "DiaMatrix.from_dense": lambda: spmv.DiaMatrix.from_dense(np.eye(4)),
        "operator_from_numpy": lambda: operator_from_numpy(
            spmv.DenseMatrix(a=torch.eye(4))),
        "laplacian_1d": lambda: matrices.laplacian_1d(8),
        "laplacian_2d": lambda: matrices.laplacian_2d(3, 3),
        "diag_spectrum": lambda: matrices.diag_spectrum(8),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(name):
    # without a card the default device raises (torch's own error on
    # .to("cuda")): nothing falls back to the CPU
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        _entry_points()[name]()


def test_load_operator_defaults_to_cuda(tmp_path):
    from ca_lanczos_tpu_torch.ops.formats import load_operator_npz, save_operator

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    path = str(tmp_path / "op.npz")
    save_operator(path, *make_operator(_op(3000), prefer="pell", device="cpu"))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        load_operator_npz(path)
    assert isinstance(load_operator_npz(path, device="cpu")[0], PellMatrix)


def test_port_never_imports_jax():
    code = ("import sys; import ca_lanczos_tpu_torch.harness.auto, "
            "ca_lanczos_tpu_torch.utils.interop, ca_lanczos_tpu_torch.ops.formats, "
            "ca_lanczos_tpu_torch.ops.pell, ca_lanczos_tpu_torch.ops.cuda_pell, "
            "ca_lanczos_tpu_torch.ops._pell_native, ca_lanczos_tpu_torch.utils._native_build, "
            "ca_lanczos_tpu_torch.ops._spmm_native, "
            "ca_lanczos_tpu_torch.ops.orth, ca_lanczos_tpu_torch.solvers, "
            "ca_lanczos_tpu_torch.solvers._block, ca_lanczos_tpu_torch.solvers.lanczos, "
            "ca_lanczos_tpu_torch.solvers.ca_lanczos, ca_lanczos_tpu_torch.solvers.restarted, "
            "ca_lanczos_tpu_torch.solvers.arnoldi, ca_lanczos_tpu_torch.solvers.implicitly_restarted, "
            "ca_lanczos_tpu_torch.utils, ca_lanczos_tpu_torch.utils.diagnostics, "
            "ca_lanczos_tpu_torch.utils.checkpoint, ca_lanczos_tpu_torch.utils.mmio, "
            "ca_lanczos_tpu_torch.utils.reorder, ca_lanczos_tpu_torch.utils.profiling, "
            "ca_lanczos_tpu_torch.utils.debug, ca_lanczos_tpu_torch.harness.corpus, "
            "ca_lanczos_tpu_torch.__main__, ca_lanczos_tpu_torch.bench, "
            "chip_smoke, chip_profile; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ca_lanczos_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
