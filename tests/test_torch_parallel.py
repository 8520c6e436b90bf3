"""PyTorch port, ``ca_lanczos_tpu_torch.parallel`` on 4 gloo ranks against
the JAX package on ``make_mesh(4)``: mirrors tests/test_parallel.py
(TestMakeMesh, TestDistSpmv, TestDistMatrixPowers, TestDistOrth,
TestDistCaLanczos, TestDistRestarted, TestScalingSweep, TestDeterminism,
the cholqr2, orth-mode and smallest-end classes, TestDistIRL,
TestDistLanczos, TestPeriodicHalo (DIA), TestDistCheckpointAndRecovery,
TestRowsNativePowers), with the same numpy inputs and the JAX tests'
tolerances.  Also the interop of a JAX DistDia's shards and the one-rank
periodic ring (a local wrap).  The ELL, PELL and BSR operators are in
tests/test_torch_dist_general.py, the s-step and propagation cases in
tests/test_torch_dist_sstep_prop.py.

The port's ranks are started once per module (``runtime.spawn`` of
``parallel.checks.run``, one torch thread each) and run every case; each
test then reads its case's answer from rank 0 (all ranks for the
cross-rank checks) and computes the JAX side here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from ca_lanczos_tpu.config import Basis, LanczosConfig, Orth, RestartStrategy
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers
from ca_lanczos_tpu.parallel import (
    DistDia,
    dist_ca_lanczos,
    dist_matrix_powers,
    dist_spmv,
    local_cholqr,
    local_tsqr,
    make_mesh,
)
from ca_lanczos_tpu.parallel.mesh import ROWS
from ca_lanczos_tpu.parallel.step import newton_coeffs
from ca_lanczos_tpu.solvers.ca_lanczos import build_basis_matrix, ca_lanczos
from ca_lanczos_tpu.utils.matrices import diag_spectrum, laplacian_1d, laplacian_2d
from ca_lanczos_tpu_torch.parallel import checks
from ca_lanczos_tpu_torch.parallel.runtime import spawn

P = 4


def _np(A):
    return np.asarray(A.data), tuple(A.offsets)


def _diag_np(n, lo=1.0, hi=100.0):
    return np.linspace(lo, hi, n)[None, :], (0,)


LAP256 = _np(laplacian_1d(256))
DIAG400 = _diag_np(400)
DIAG400W = _diag_np(400, 1.0, 1000.0)
X128 = np.random.default_rng(0).standard_normal(128)
X123 = np.random.default_rng(1).standard_normal(123)
X256 = np.random.default_rng(2).standard_normal(256)
X2D = np.random.default_rng(3).standard_normal(16 * 64)
X4096 = np.random.default_rng(7).standard_normal(4096)
_rng = np.random.default_rng(9)
DG4, SB4 = _rng.standard_normal(4), _rng.standard_normal(4)
XQR = np.random.default_rng(4).standard_normal((512, 7))
XCH = np.random.default_rng(5).standard_normal((512, 5))
_rng = np.random.default_rng(0)
XDEF = _rng.standard_normal((512, 6))
XDEF[:, 3] = XDEF[:, 1]
XDEF[:, 5] = 2.0 * XDEF[:, 0] - XDEF[:, 2]
XFULL = np.random.default_rng(1).standard_normal((512, 5))
_rng = np.random.default_rng(0)
PER_DATA = _rng.standard_normal((5, 256))
X_PER = _rng.standard_normal(256)
PER_OFFS = (-2, -1, 0, 1, 2)
XL = np.random.default_rng(11).standard_normal(256)
R_EIG = np.zeros(400)
R_EIG[-1] = 1.0


def _smallest_end():
    d = np.linspace(0.0, 1.0, 480)
    d[-3:] = [4.0, 5.0, 6.0]
    d[:4] = [-2.0, -1.7, -1.4, -1.1]
    return d[None, :], (0,)


SMALL = _smallest_end()


def _cluster(n):
    """chip_smoke.py phase F's recipe at a small n: a planted top cluster of
    10 spaced 0.01 over 1..90 that decouples exactly."""
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = 99.0 + 0.01 * np.arange(10)
    off = np.random.default_rng(0).standard_normal(n) * 1e-3
    off[n - 11:] = 0.0
    data = np.zeros((3, n))
    data[0, 1:] = off[:-1]
    data[1] = d
    data[2, :-1] = off[:-1]
    return data, (-1, 0, 1)


CLUSTER = _cluster(4096)
IRL_CLUSTER = dict(max_lanczos=48, n_wanted=10, s=8, tol=1e-4, max_restarts=200)
CFG6 = dict(s=4, basis="newton", orth="local", n_wanted=6, tol=1e-8)


def _cfg(**kw):
    from ca_lanczos_tpu_torch.config import LanczosConfig as TCfg
    from ca_lanczos_tpu_torch.config import OrthParams as TOP
    from ca_lanczos_tpu_torch.config import QrMethod as TQ

    kw = dict(kw)
    if "qr_method" in kw:
        kw["orth_params"] = TOP(qr_method=TQ(kw.pop("qr_method")))
    return TCfg(**kw)


def _bk_newton(data, offsets, r, s):
    from ca_lanczos_tpu.ops.spmv import DiaMatrix

    A = DiaMatrix(data=jnp.asarray(data), offsets=offsets)
    q = jnp.asarray(r) / jnp.linalg.norm(jnp.asarray(r))
    return np.asarray(build_basis_matrix(A, q, s, Basis.NEWTON))


def _specs(tmp):
    lap2d = _np(laplacian_2d(16, 64))
    dg2d, sb2d = newton_coeffs(_bk_newton(*lap2d, X2D, 4))
    lap4k = _np(laplacian_1d(4096))
    bk400 = _bk_newton(*DIAG400, np.ones(400), 4)
    ck = str(tmp / "dist_ck.npz")
    specs = [
        ("mesh8", "make_mesh_refuses", dict(n=8)),
        ("mesh2", "make_mesh_refuses", dict(n=2)),
        ("spmv", "spmv", dict(data=_np(laplacian_1d(128))[0], offsets=(-1, 0, 1), x=X128,
                              s_max=4)),
        ("spmv_uneven", "spmv", dict(data=_np(laplacian_1d(123))[0], offsets=(-1, 0, 1),
                                     x=X123, s_max=2)),
        ("newton2d", "powers", dict(data=lap2d[0], offsets=lap2d[1], x=X2D, s=4, diag=dg2d,
                                    sub=sb2d)),
        ("newton4k", "powers", dict(data=lap4k[0], offsets=lap4k[1], x=X4096, s=4, diag=DG4,
                                    sub=SB4)),
        ("tsqr", "qr", dict(X=XQR)),
        ("cholqr", "qr", dict(X=XCH, method="cholqr")),
        ("ca_newton", "ca_lanczos", dict(data=DIAG400[0], offsets=(0,), r=np.ones(400), s=4,
                                         steps=48, basis="newton", Bk=bk400)),
        ("ca_orthonormal", "ca_lanczos", dict(data=LAP256[0], offsets=LAP256[1],
                                              r=np.ones(256), s=4, steps=16, want_Q=True)),
        ("ca_full48", "ca_lanczos", dict(data=DIAG400W[0], offsets=(0,), r=np.ones(400), s=4,
                                         steps=48, orth="full", want_Q=True)),
        ("ca_local48", "ca_lanczos", dict(data=DIAG400W[0], offsets=(0,), r=np.ones(400),
                                          s=4, steps=48, orth="local", want_Q=True)),
        ("ca_tsqr", "ca_lanczos", dict(data=DIAG400[0], offsets=(0,), r=np.ones(400), s=4,
                                       steps=32, basis="newton", Bk=bk400, qr_method="tsqr")),
        ("ca_cholqr2", "ca_lanczos", dict(data=DIAG400[0], offsets=(0,), r=np.ones(400), s=4,
                                          steps=32, basis="newton", Bk=bk400,
                                          qr_method="cholqr2")),
        ("rst", "restarted", dict(data=DIAG400[0], offsets=(0,), r=np.ones(400),
                                  max_lanczos=32, cfg=_cfg(**CFG6))),
        ("rst_cholqr2", "restarted", dict(data=DIAG400[0], offsets=(0,), r=np.ones(400),
                                          max_lanczos=32,
                                          cfg=_cfg(s=4, basis="newton", n_wanted=6, tol=1e-8,
                                                   qr_method="cholqr2"))),
        ("rst_small", "restarted", dict(data=SMALL[0], offsets=(0,), r=np.ones(480),
                                        max_lanczos=24,
                                        cfg=_cfg(s=4, n_wanted=3, tol=1e-7, max_restarts=100,
                                                 orth="full", restart_strategy="smallest"))),
        ("lanczos", "lanczos", dict(data=LAP256[0], offsets=LAP256[1], r=XL, maxiter=20)),
        ("periodic", "spmv", dict(data=PER_DATA, offsets=PER_OFFS, x=X_PER, s_max=2,
                                  periodic=True)),
        ("ckpt_partial", "restarted", dict(data=DIAG400[0], offsets=(0,), r=np.ones(400),
                                           max_lanczos=32, cfg=_cfg(**CFG6, max_restarts=1),
                                           checkpoint_path=ck)),
        ("ckpt_resume", "restarted", dict(data=DIAG400[0], offsets=(0,), r=np.ones(400),
                                          max_lanczos=32, cfg=_cfg(**CFG6), resume_from=ck)),
        ("qr_safe_def", "qr", dict(X=XDEF, safe=True, key=7)),
        ("qr_safe_full", "qr", dict(X=XFULL, safe=True, key=3)),
        ("qr_plain_full", "qr", dict(X=XFULL)),
        ("rank_def", "restarted", dict(data=DIAG400[0], offsets=(0,), r=R_EIG, max_lanczos=32,
                                       cfg=_cfg(s=4, basis="monomial", orth="local",
                                                n_wanted=4, tol=1e-8), safe_qr=True)),
        ("rows", "powers", dict(data=LAP256[0], offsets=LAP256[1], x=X256, s=4, rows=True)),
        ("cols", "powers", dict(data=LAP256[0], offsets=LAP256[1], x=X256, s=4)),
        ("determinism", "determinism", dict(data=LAP256[0], offsets=LAP256[1], s=4)),
    ]
    for s in (1, 2, 4, 8):
        specs.append((f"mono{s}", "powers", dict(data=LAP256[0], offsets=LAP256[1], x=X256,
                                                 s=s)))
    for s in (2, 4):
        specs.append((f"ca_mono{s}", "ca_lanczos", dict(data=LAP256[0], offsets=LAP256[1],
                                                        r=np.ones(256), s=s, steps=24)))
    for o in ("full", "periodic", "selective"):
        specs.append((f"ca_{o}", "ca_lanczos", dict(data=DIAG400W[0], offsets=(0,),
                                                    r=np.ones(400), s=4, steps=40, orth=o,
                                                    want_Q=True)))
        specs.append((f"rst_{o}", "restarted", dict(
            data=DIAG400[0], offsets=(0,), r=np.ones(400), max_lanczos=32,
            cfg=_cfg(s=4, basis="newton", orth=o, n_wanted=6, tol=1e-8))))
    for b in ("monomial", "newton"):
        specs.append((f"irl_{b}", "irl", dict(data=DIAG400[0], offsets=(0,), r=np.ones(400),
                                              max_lanczos=40, n_wanted=6, s=4, basis=b,
                                              tol=1e-8)))
    specs.append(("irl_cluster", "irl", dict(data=CLUSTER[0], offsets=CLUSTER[1],
                                            r=np.ones(4096), **IRL_CLUSTER)))
    for tag, A, s_max, periodic in _interop_ops():
        jd = np.asarray(DistDia.from_dia(A, make_mesh(P), s_max=s_max, periodic=periodic).data)
        specs.append((f"interop_{tag}", "interop", dict(
            jdata=jd, offsets=tuple(A.offsets), halo=(jd.shape[2] - _n_local(A)) // 2,
            n=A.data.shape[1], periodic=periodic, s_max=s_max, ilv=tag == "ilv")))
    return specs


def _n_local(A):
    return -(-A.data.shape[1] // P)


def _interop_ops():
    from ca_lanczos_tpu.ops.spmv import DiaMatrix

    rng = np.random.default_rng(31)
    off = (rng.standard_normal(8192) * 0.05).astype(np.float32)
    data = np.zeros((3, 8192), np.float32)
    data[1] = np.linspace(0.5, 2.0, 8192)
    data[0, 1:] = off[:-1]
    data[2, :-1] = off[:-1]
    return [
        ("lap", laplacian_1d(256), 4, False),
        ("uneven", laplacian_1d(123), 2, False),
        ("periodic", DiaMatrix(data=jnp.asarray(PER_DATA), offsets=PER_OFFS), 2, True),
        ("ilv", DiaMatrix(data=jnp.asarray(data), offsets=(-1, 0, 1)), 4, False),
    ]


P1_SPECS = [
    ("periodic", "spmv", dict(data=PER_DATA, offsets=PER_OFFS, x=X_PER, s_max=2, periodic=True)),
    ("periodic_powers", "powers", dict(data=PER_DATA, offsets=PER_OFFS, x=X_PER, s=4,
                                       periodic=True)),
    ("determinism", "determinism", dict(data=LAP256[0], offsets=LAP256[1], s=4)),
]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spawn(checks.run, P, "cpu", _specs(tmp_path_factory.mktemp("ck")), threads=1,
                 timeout=600)


@pytest.fixture(scope="module")
def port1():
    return spawn(checks.run, 1, "cpu", P1_SPECS, threads=1, timeout=300)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(P)


def get(port, cid, rank=0):
    out = port[rank][cid]
    if isinstance(out, dict) and "__error__" in out:
        pytest.fail(f"rank {rank}, case {cid}:\n{out['__error__']}")
    return out


def _jdia(data, offsets):
    from ca_lanczos_tpu.ops.spmv import DiaMatrix

    return DiaMatrix(data=jnp.asarray(data), offsets=tuple(offsets))


def _jpowers(mesh, A, x, s, diag=None, sub=None, periodic=False):
    Ad = DistDia.from_dia(A, mesh, s_max=s, periodic=periodic)
    z = jnp.zeros(s)
    dg = z if diag is None else jnp.asarray(diag)
    sb = z if sub is None else jnp.asarray(sub)
    return np.asarray(dist_matrix_powers(Ad, Ad.shard_vector(x, mesh), s, dg, sb, mesh))[
        : A.data.shape[1]]


class TestMakeMesh:
    def test_more_devices_than_visible_raises(self, port):
        assert "only 4 rank" in get(port, "mesh8")
        assert "spans all" in get(port, "mesh2")
        with pytest.raises(ValueError, match="only 8 device"):
            make_mesh(16)


class TestDistSpmv:
    def test_matches_local(self, port, mesh):
        A = laplacian_1d(128)
        Ad = DistDia.from_dia(A, mesh, s_max=4)
        y_j = np.asarray(dist_spmv(Ad, Ad.shard_vector(X128, mesh), mesh))[:128]
        y = get(port, "spmv")
        np.testing.assert_allclose(y, np.asarray(A.matvec(jnp.asarray(X128))), atol=1e-13)
        np.testing.assert_allclose(y, y_j, atol=1e-13)

    def test_wider_state_casts_planes_once(self):
        """f64 state on f32 planes (the IRL on an f32 matrix): the product
        is the f64 one, through one cast copy of the shard's planes kept on
        the operator, not a copy per call."""
        import torch

        from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix as TDia
        from ca_lanczos_tpu_torch.parallel.distributed import DistDia as TDist
        from ca_lanczos_tpu_torch.parallel.mesh import ROWS as TROWS
        from ca_lanczos_tpu_torch.parallel.mesh import Mesh

        data = LAP256[0].astype(np.float32)
        one = Mesh(shape=(1,), axis_names=(TROWS,), rank=0, device=torch.device("cpu"))
        Ad = TDist.from_dia(TDia(data=torch.as_tensor(data), offsets=LAP256[1]), one, s_max=4)
        p64 = Ad.planes(torch.float64)
        assert p64.dtype == torch.float64 and Ad.planes(torch.float64) is p64
        assert Ad.planes(torch.float32) is Ad.data
        np.testing.assert_array_equal(p64.numpy(), Ad.data.numpy().astype(np.float64))

    def test_uneven_rows_padded(self, port):
        A = laplacian_1d(123)
        np.testing.assert_allclose(get(port, "spmv_uneven"),
                                   np.asarray(A.matvec(jnp.asarray(X123))), atol=1e-13)


class TestDistMatrixPowers:
    @pytest.mark.parametrize("s", [1, 2, 4, 8])
    def test_monomial(self, port, mesh, s):
        A = laplacian_1d(256)
        V = get(port, f"mono{s}")
        V_ref = np.asarray(matrix_powers(A, jnp.asarray(X256), s, None, Basis.MONOMIAL))
        np.testing.assert_allclose(V, V_ref, rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(V, _jpowers(mesh, A, X256, s), rtol=1e-12, atol=1e-10)

    def test_newton_2d(self, port, mesh):
        from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_from_B

        A = laplacian_2d(16, 64)
        q = jnp.asarray(X2D)
        Bk = build_basis_matrix(A, q / jnp.linalg.norm(q), 4, Basis.NEWTON)
        V_ref = np.asarray(matrix_powers_from_B(A, q, Bk))
        np.testing.assert_allclose(get(port, "newton2d"), V_ref, rtol=1e-12, atol=1e-10)

    def test_random_newton_coeffs(self, port, mesh):
        """Nonzero three-term coefficients at n_local = 1024 (the JAX
        test's fused-kernel shape) against the JAX distributed powers."""
        V_j = _jpowers(mesh, laplacian_1d(4096), X4096, 4, DG4, SB4)
        np.testing.assert_allclose(get(port, "newton4k"), V_j, rtol=1e-13, atol=1e-12)


def _jqr(mesh, fn, X):
    Xs = jax.device_put(jnp.asarray(X), jax.NamedSharding(mesh, PartitionSpec(ROWS)))
    Q, R = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=PartitionSpec(ROWS),
                                 out_specs=(PartitionSpec(ROWS), PartitionSpec())))(Xs)
    return np.asarray(Q), np.asarray(R)


class TestDistOrth:
    def test_tsqr(self, port, mesh):
        from ca_lanczos_tpu.ops.qr import tsqr

        out = get(port, "tsqr")
        Q, R = out["Q"], out["R"]
        assert np.all(np.diag(R) >= 0)
        np.testing.assert_allclose(Q @ R, XQR, atol=1e-12)
        np.testing.assert_allclose(Q.T @ Q, np.eye(7), atol=1e-12)
        _, Rr = tsqr(jnp.asarray(XQR))
        np.testing.assert_allclose(R, np.asarray(Rr), rtol=1e-8, atol=1e-10)
        Qj, Rj = _jqr(mesh, local_tsqr, XQR)
        np.testing.assert_allclose(R, Rj, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(Q, Qj, atol=1e-10)

    def test_cholqr(self, port, mesh):
        out = get(port, "cholqr")
        Q, R = out["Q"], out["R"]
        np.testing.assert_allclose(Q @ R, XCH, atol=1e-10)
        np.testing.assert_allclose(Q.T @ Q, np.eye(5), atol=1e-10)
        _, Rj = _jqr(mesh, local_cholqr, XCH)
        np.testing.assert_allclose(R, Rj, rtol=1e-8, atol=1e-10)


def _eigs(T):
    return np.sort(np.linalg.eigvalsh(np.asarray(T)))


class TestDistCaLanczos:
    @pytest.mark.parametrize("s", [2, 4])
    def test_ritz_parity_monomial(self, port, mesh, s):
        A = laplacian_1d(256)
        r = jnp.ones((256,), jnp.float64)
        res_j = dist_ca_lanczos(A, r, s, 24, mesh, basis=Basis.MONOMIAL)
        res_1 = ca_lanczos(A, r, s, 24, basis=Basis.MONOMIAL, orth=Orth.LOCAL)
        d = _eigs(get(port, f"ca_mono{s}")["T"])
        np.testing.assert_allclose(d, _eigs(res_1.T), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(d, _eigs(res_j.T), rtol=1e-9, atol=1e-9)

    def test_ritz_parity_newton(self, port, mesh):
        A = diag_spectrum(400, 1.0, 100.0)
        r = jnp.ones((400,), jnp.float64)
        Bk = build_basis_matrix(A, r / jnp.linalg.norm(r), 4, Basis.NEWTON)
        res_j = dist_ca_lanczos(A, r, 4, 48, mesh, basis=Basis.NEWTON, Bk=Bk)
        d = _eigs(get(port, "ca_newton")["T"])
        np.testing.assert_allclose(d, _eigs(res_j.T), rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(d[-1], 100.0, rtol=1e-4)

    def test_basis_orthonormal(self, port):
        Q = get(port, "ca_orthonormal")["Q"]
        np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-8)

    @pytest.mark.parametrize("orth", ["full", "periodic", "selective"])
    def test_orth_modes_parity(self, port, mesh, orth):
        A = diag_spectrum(400, 1.0, 1000.0)
        r = jnp.ones((400,), jnp.float64)
        res_j = dist_ca_lanczos(A, r, 4, 40, mesh, basis=Basis.MONOMIAL, orth=Orth(orth))
        res_1 = ca_lanczos(A, r, 4, 40, basis=Basis.MONOMIAL, orth=Orth(orth))
        out = get(port, f"ca_{orth}")
        d = _eigs(out["T"])
        np.testing.assert_allclose(d[-5:], _eigs(res_1.T)[-5:], rtol=1e-6)
        np.testing.assert_allclose(d[-5:], _eigs(res_j.T)[-5:], rtol=1e-6)
        if orth == "full":
            Q = out["Q"]
            np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-8)

    def test_full_orth_beats_local(self, port):
        qf, ql = get(port, "ca_full48")["Q"], get(port, "ca_local48")["Q"]
        e_full = np.max(np.abs(qf.T @ qf - np.eye(qf.shape[1])))
        e_local = np.max(np.abs(ql.T @ ql - np.eye(ql.shape[1])))
        assert e_full < 1e-10
        assert e_full < e_local


EXACT6 = np.linspace(1, 100, 400)[::-1][:6]


class TestDistRestarted:
    def test_flagship_parity(self, port, mesh):
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        out = get(port, "rst")
        assert out["converged"]
        got = np.sort(out["eigs"])[::-1]
        np.testing.assert_allclose(got, EXACT6, rtol=1e-9)
        Q = out["Q"]
        np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-8)
        cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=Orth.LOCAL, n_wanted=6, tol=1e-8)
        res_j = dist_restarted_ca_lanczos(diag_spectrum(400), np.ones(400), 32, mesh, cfg)
        np.testing.assert_allclose(got, np.sort(res_j.eigs)[::-1], rtol=1e-9)
        assert out["n_restarts"] == res_j.n_restarts


class TestScalingSweep:
    def test_weak_scaling_plumbing(self):
        from ca_lanczos_tpu_torch.parallel.runtime import scaling_sweep

        recs = scaling_sweep((1, 2, 4), rows_per_device=4096, s=4, reps=2, device="cpu")
        assert [r["devices"] for r in recs] == [1, 2, 4]
        for r in recs:
            assert r["nnz_per_s"] > 0
        assert recs[0]["weak_efficiency"] == 1.0


class TestDeterminism:
    def test_dist_block_step_bitwise_deterministic(self, port):
        assert all(get(port, "determinism", k)["deterministic"] for k in range(P))

    def test_replicated_R_consistent_across_devices(self, port, port1):
        assert all(get(port, "determinism", k)["spread"] == 0.0 for k in range(P))
        assert get(port1, "determinism")["spread"] == 0.0  # one rank

    def test_assert_finite(self):
        import torch

        from ca_lanczos_tpu_torch.utils.debug import assert_finite

        assert_finite({"a": torch.ones(3)})
        with pytest.raises(FloatingPointError):
            assert_finite(torch.tensor([1.0, np.nan]))


class TestDistCholqr2Path:
    def test_dist_driver_cholqr2_parity(self, port):
        d_t = _eigs(get(port, "ca_tsqr")["T"])
        d_c = _eigs(get(port, "ca_cholqr2")["T"])
        np.testing.assert_allclose(d_c, d_t, rtol=1e-9, atol=1e-9)


class TestDistRestartedCholqr2:
    def test_flagship_cholqr2(self, port):
        out = get(port, "rst_cholqr2")
        assert out["converged"]
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], EXACT6, rtol=1e-9)


class TestDistRestartedOrthModes:
    @pytest.mark.parametrize("orth", ["full", "periodic", "selective"])
    def test_flagship_orth_modes(self, port, orth):
        out = get(port, f"rst_{orth}")
        assert out["converged"]
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], EXACT6, rtol=1e-9)
        Q = out["Q"]
        np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-9)


class TestDistRestartedSmallestEnd:
    def test_returns_smallest_end(self, port, mesh):
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        out = get(port, "rst_small")
        assert out["converged"]
        got = np.sort(out["eigs"])[:3]
        np.testing.assert_allclose(got, [-2.0, -1.7, -1.4], atol=1e-6)
        assert np.all(got < 0.0), got
        cfg = LanczosConfig(s=4, n_wanted=3, tol=1e-7, max_restarts=100, orth=Orth.FULL,
                            restart_strategy=RestartStrategy.SMALLEST)
        res_j = dist_restarted_ca_lanczos(_jdia(*SMALL), np.ones(480), 24, mesh, cfg)
        np.testing.assert_allclose(got, np.sort(res_j.eigs)[:3], atol=1e-6)


class TestDistIRL:
    @pytest.mark.parametrize("basis", ["monomial", "newton"])
    def test_diagonal(self, port, mesh, basis):
        from ca_lanczos_tpu.parallel.dist_irl import dist_impl_restarted_ca_lanczos

        out = get(port, f"irl_{basis}")
        assert out["converged"]
        np.testing.assert_allclose(out["eigs"], EXACT6, rtol=1e-8)
        res_j = dist_impl_restarted_ca_lanczos(diag_spectrum(400, 1.0, 100.0), np.ones(400), 40,
                                               mesh, n_wanted=6, s=4, basis=basis, tol=1e-8)
        assert out["n_restarts"] == res_j.n_restarts
        np.testing.assert_allclose(out["eigs"], np.asarray(res_j.eigs), rtol=1e-10)

    def test_cluster_matches_jax(self, port, mesh):
        """chip_smoke.py phase F's clustered f64 matrix at 4,096 rows with
        J(c)'s settings: the compression, the residual update and the Ritz
        verification run several restarts, each as the JAX driver does."""
        from ca_lanczos_tpu.parallel.dist_irl import dist_impl_restarted_ca_lanczos

        out = get(port, "irl_cluster")
        kw = dict(IRL_CLUSTER)
        res_j = dist_impl_restarted_ca_lanczos(_jdia(*CLUSTER), np.ones(4096),
                                               kw.pop("max_lanczos"), mesh, **kw)
        assert out["converged"] and res_j.converged
        assert out["n_restarts"] == res_j.n_restarts > 1
        np.testing.assert_allclose(out["eigs"], np.asarray(res_j.eigs), rtol=1e-10)
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], CLUSTER[0][1, -10:][::-1],
                                   rtol=1e-10)


class TestDistLanczos:
    def test_matches_single_chip(self, port, mesh):
        from ca_lanczos_tpu.parallel import dist_lanczos
        from ca_lanczos_tpu.solvers.lanczos import lanczos as lanczos_1

        A = laplacian_1d(256)
        res = lanczos_1(A, jnp.asarray(XL), 20, orth="local")
        T = get(port, "lanczos")
        np.testing.assert_allclose(T, res.T, rtol=1e-10, atol=1e-12)
        T_j, _ = dist_lanczos(A, XL, 20, mesh)
        np.testing.assert_allclose(T, T_j, rtol=1e-10, atol=1e-12)


def _circulant(data, offsets):
    n = data.shape[1]
    dense = np.zeros((n, n))
    for d, k in enumerate(offsets):
        dense[np.arange(n), (np.arange(n) + k) % n] = data[d]
    return dense


class TestPeriodicHalo:
    def test_periodic_dia_spmv(self, port, mesh):
        y = get(port, "periodic")
        np.testing.assert_allclose(y, _circulant(PER_DATA, PER_OFFS) @ X_PER, atol=1e-12)
        Ad = DistDia.from_dia(_jdia(PER_DATA, PER_OFFS), mesh, s_max=2, periodic=True)
        y_j = np.asarray(dist_spmv(Ad, Ad.shard_vector(X_PER, mesh), mesh))[:256]
        np.testing.assert_allclose(y, y_j, atol=1e-12)

    def test_one_rank_ring_wraps_locally(self, port1):
        """P = 1: the periodic ring is a local wrap (a send to oneself is
        refused), for the product and for s = 4 powers (JAX make_mesh(1))."""
        dense = _circulant(PER_DATA, PER_OFFS)
        np.testing.assert_allclose(get(port1, "periodic"), dense @ X_PER, atol=1e-12)
        V_j = _jpowers(make_mesh(1), _jdia(PER_DATA, PER_OFFS), X_PER, 4, periodic=True)
        np.testing.assert_allclose(get(port1, "periodic_powers"), V_j, rtol=1e-12, atol=1e-10)


class TestDistCheckpointAndRecovery:
    def test_kill_resume_mid_solve(self, port):
        ref, part, res = (get(port, c) for c in ("rst", "ckpt_partial", "ckpt_resume"))
        assert ref["converged"]
        assert not part["converged"]
        assert res["converged"]
        np.testing.assert_allclose(np.sort(res["eigs"]), np.sort(ref["eigs"]), rtol=1e-9)

    def test_local_qr_safe_rank_deficient(self, port):
        out = get(port, "qr_safe_def")
        Q = out["Q"]
        assert int(out["rank"]) == 4
        np.testing.assert_allclose(Q.T @ Q, np.eye(6), atol=1e-10)
        np.testing.assert_allclose(Q @ (Q.T @ XDEF), XDEF, atol=1e-10)

    def test_local_qr_safe_full_rank_passthrough(self, port):
        safe, plain = get(port, "qr_safe_full"), get(port, "qr_plain_full")
        assert int(safe["rank"]) == 5
        np.testing.assert_allclose(safe["Q"], plain["Q"], atol=1e-12)
        np.testing.assert_allclose(safe["R"], plain["R"], atol=1e-12)

    def test_rank_deficient_block_converges(self, port):
        out = get(port, "rank_def")
        assert out["converged"]
        got = np.sort(out["eigs"])[::-1]
        np.testing.assert_allclose(got, np.linspace(1, 100, 400)[::-1][:4], rtol=1e-4)
        np.testing.assert_allclose(got[0], 100.0, rtol=1e-12)


class TestRowsNativePowers:
    def test_matches_column_api(self, port):
        np.testing.assert_allclose(get(port, "rows").T, get(port, "cols")[:, 1:], atol=1e-13)


class TestInterop:
    @pytest.mark.parametrize("tag", ["lap", "uneven", "periodic", "ilv"])
    def test_shard_planes_equal_jax(self, port, tag):
        """Every rank's planes equal JAX's DistDia.from_dia(A, make_mesh(4),
        s_max) shard p exactly, built by the port's from_dia and by
        utils.interop.dist_dia_from_numpy; the interleaved planes the
        interop rebuilds equal from_dia's."""
        A, s_max, periodic = next((a, s, p) for t, a, s, p in _interop_ops() if t == tag)
        jd = np.asarray(DistDia.from_dia(A, make_mesh(P), s_max=s_max, periodic=periodic).data)
        for p in range(P):
            out = get(port, f"interop_{tag}", p)
            np.testing.assert_array_equal(out["from_dia"], jd[p])
            np.testing.assert_array_equal(out["interop"], jd[p])
            if tag == "ilv":
                assert out["from_dia_ilv"] is not None
                np.testing.assert_array_equal(out["interop_ilv"], out["from_dia_ilv"])


class TestEntry:
    def test_entry_block_step(self):
        """entry(): the single-card CA block step (``__graft_entry__.entry``)."""
        from ca_lanczos_tpu_torch.entry import entry

        fn, (A, Q_prev) = entry(device="cpu")
        Q_new, R, Rn = fn(A, Q_prev)
        assert tuple(Q_new.shape) == (256, 6) and tuple(R.shape) == (7, 6)
        np.testing.assert_allclose((Q_new.T @ Q_new).numpy(), np.eye(6), atol=1e-5)
        np.testing.assert_allclose((Q_prev.T @ Q_new).numpy(), 0.0, atol=1e-3)

    def test_dryrun_multichip_cpu(self):
        """dryrun_multichip(4) on gloo ranks: every engine holds Ritz parity
        (the PELL engine and the hierarchical 2 x 2 mesh included)."""
        from ca_lanczos_tpu_torch.entry import dryrun_multichip

        out = dryrun_multichip(P, device="cpu", timeout=300)
        assert out["ranks"] == P and "hier ilv" in out["checked"]
        assert "pell" in out["checked"]
