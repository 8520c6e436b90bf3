"""PyTorch port, ``parallel.dist_solve_auto`` and ``route_dist_operator`` on
4 gloo ranks against the JAX package on ``make_mesh(4)``: mirrors
tests/test_dist_auto.py (routing, the escalating solve, the two-stage
polish, the RCM-reordered band, the Ritz-vector alignment regression and
the mixed-precision T accuracy) with its tolerances, plus the IRL first
rung on a clustered spectrum against JAX's ``dist_solve_auto``, and the
general-sparsity route: a bounded-bandwidth non-DIA matrix routes to
"pell" as in JAX, partitions as a DistPell and solves with JAX's label,
restart count and eigenvalues.  Also the CLI's ``solve
--mesh 4`` (and ``--hosts 2``) against the dense oracle, and the f64 polish of
a block with no solve operator (``solvers.polish.f64_operator`` with
``A_solve=None``, the branch the distributed solve takes).
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ca_lanczos_tpu.config import LanczosConfig
from ca_lanczos_tpu.parallel import dist_solve_auto, make_mesh, route_dist_operator
from ca_lanczos_tpu_torch.config import LanczosConfig as TCfg
from ca_lanczos_tpu_torch.parallel import checks
from ca_lanczos_tpu_torch.parallel.runtime import spawn
from ca_lanczos_tpu_torch.utils.mmio import save_mtx
from tests.test_torch_pell import pin_encoder


@pytest.fixture(autouse=True, scope="module")
def _jax_native_encoder():
    """JAX's PELL encoder on its native path, as the port's (``pin_encoder``):
    the PELL route's restart count is compared with JAX's."""
    with pytest.MonkeyPatch.context() as mp:
        pin_encoder(mp, "native")
        yield


P = 4


def _band(n, d, off=0.05):
    o = off * np.ones(n - 1)
    return sp.diags([d, o, o], [0, -1, 1]).tocsr()


BAND = _band(1024, np.linspace(1.0, 50.0, 1024))
_p = np.random.default_rng(0).permutation(2048)
_b2 = _band(2048, 2.0 * np.ones(2048))
SCAT = sp.csr_matrix(_b2[_p][:, _p])


def _unshardable():
    n = 512
    rng = np.random.default_rng(1)
    rows = np.repeat(np.arange(n), 4)
    cols = rng.integers(0, n, rows.shape)
    a = sp.csr_matrix((np.ones(rows.shape), (rows, cols)), (n, n))
    return (a + a.T).tocsr()


UNSHARD = _unshardable()


def _general():
    """A symmetric band of half-width 60 with 3 random nonzeros a row: too
    many diagonals for DIA, bounded bandwidth (the JAX package's DistPell
    case)."""
    n, rng = 1024, np.random.default_rng(2)
    rows = np.repeat(np.arange(n), 3)
    cols = np.clip(rows + rng.integers(-60, 61, rows.shape), 0, n - 1)
    a = sp.csr_matrix((rng.standard_normal(rows.shape) * 0.01, (rows, cols)), (n, n))
    return (a + a.T + sp.diags(np.linspace(1.0, 2.0, n))).tocsr()


GENERAL = _general()
GEN_CFG = dict(n_wanted=4, s=4, tol=1e-8)
D_SOLVE = np.linspace(1.0, 100.0, 1024)
A_SOLVE = _band(1024, D_SOLVE)
D_POL = np.linspace(1.0, 90.0, 1024)
D_POL[-4:] = np.linspace(95.0, 100.0, 4)
A_POL = _band(1024, D_POL)
_d = np.linspace(1.0, 2.0, 1024)
_d[-1] = 3.0
_band_r = _band(1024, _d, off=0.01)
_rng = np.random.default_rng(3)
_pr = _rng.permutation(1024)
SCAT_R = sp.csr_matrix(_band_r[_pr][:, _pr])
R_SCAT = _rng.standard_normal(1024)
A_ALIGN = _band(1024, np.r_[np.linspace(1.0, 2.0, 1023), 3.0], off=0.01)
R_ALIGN = np.random.default_rng(3).standard_normal(1024)


def _diag2048():
    d = np.linspace(1.0, 60.0, 2048)
    return d[None, :], d.astype(np.float32)[None, :]


D64, D32 = _diag2048()


def _cluster(n):
    """chip_smoke.py phase F's recipe at a small n: a planted top cluster of
    10 spaced 0.01 over 1..90 that decouples exactly; the probe finds it."""
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = 99.0 + 0.01 * np.arange(10)
    off = np.random.default_rng(0).standard_normal(n) * 1e-3
    off[n - 11:] = 0.0
    return sp.diags([off[:-1], d, off[:-1]], [-1, 0, 1], format="csr"), d[-10:][::-1]


A_CL, EXACT_CL = _cluster(4096)
CL_CFG = dict(n_wanted=10, s=8, tol=1e-4, max_restarts=200)
R_MP = np.random.default_rng(0).standard_normal(2048)

SPECS = [
    ("route_band", "route", dict(a=BAND, s_max=4)),
    ("route_rcm", "route", dict(a=SCAT, s_max=4)),
    ("route_unshard", "route", dict(a=UNSHARD, s_max=8)),
    ("route_general", "route", dict(a=GENERAL, s_max=4)),
    ("refuse_object", "partition", dict()),
    ("part_general", "partition", dict(a=GENERAL, dist_format="pell")),
    ("solve_general", "solve_auto", dict(a=GENERAL, r=np.ones(1024), max_lanczos=32,
                                         cfg=TCfg(**GEN_CFG))),
    ("solve", "solve_auto", dict(a=A_SOLVE, r=np.ones(1024), max_lanczos=32,
                                 cfg=TCfg(n_wanted=4, s=4, tol=1e-9))),
    ("polish", "solve_auto", dict(a=A_POL, r=np.ones(1024), max_lanczos=32,
                                  cfg=TCfg(n_wanted=4, s=4, tol=1e-5, max_restarts=100),
                                  polish=6, over_lock=2)),
    ("irl_first", "solve_auto", dict(a=A_CL, r=np.ones(4096), max_lanczos=48,
                                     cfg=TCfg(**CL_CFG), polish=10, over_lock=3)),
    ("reordered", "solve_auto", dict(a=SCAT_R, r=R_SCAT, max_lanczos=24,
                                     cfg=TCfg(n_wanted=1, s=4, tol=1e-9))),
    ("align", "restarted", dict(data=None, offsets=None, r=R_ALIGN, max_lanczos=24,
                                cfg=TCfg(n_wanted=2, s=4, tol=1e-9))),
    ("mp64", "ca_lanczos", dict(data=D64, offsets=(0,), r=R_MP, s=4, steps=16)),
    ("mp32", "ca_lanczos", dict(data=D32, offsets=(0,), r=R_MP.astype(np.float32), s=4,
                                steps=16)),
    ("mpmp", "ca_lanczos", dict(data=D32, offsets=(0,), r=R_MP.astype(np.float32), s=4,
                                steps=16, mixed_precision=True)),
]


def _align_planes():
    from ca_lanczos_tpu_torch.ops.formats import dia_from_scipy

    A = dia_from_scipy(A_ALIGN, device="cpu")
    return A.data.numpy(), A.offsets


@pytest.fixture(scope="module")
def port():
    data, offsets = _align_planes()
    specs = [(c, f, dict(kw, data=data, offsets=offsets) if c == "align" else kw)
             for c, f, kw in SPECS]
    return spawn(checks.run, P, "cpu", specs, threads=1, timeout=600)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(P)


def get(port, cid, rank=0):
    out = port[rank][cid]
    if isinstance(out, dict) and "__error__" in out:
        pytest.fail(f"rank {rank}, case {cid}:\n{out['__error__']}")
    return out


def _oracle(a, k):
    from scipy.sparse.linalg import eigsh

    return np.sort(eigsh(a, k=k, which="LA", return_eigenvectors=False))[::-1]


class TestRouteDistOperator:
    def test_banded_to_dia(self, port, mesh):
        out = get(port, "route_band")
        A, fmt, route = route_dist_operator(BAND, mesh, s_max=4)
        assert out["type"] == "DiaMatrix" and out["format"] == fmt == "dia"
        assert out["perm_none"] and route.perm is None

    def test_wide_band_needs_rcm(self, port, mesh):
        out = get(port, "route_rcm")
        _, fmt, route = route_dist_operator(SCAT, mesh, s_max=4)
        assert not out["perm_none"]
        assert out["bw_after"] < out["bw_before"]
        assert (out["format"], out["bw_before"], out["bw_after"]) == (
            fmt, route.bandwidth_before, route.bandwidth_after)

    def test_unshardable_raises(self, port, mesh):
        assert "row-sharded" in get(port, "route_unshard")["error"]
        with pytest.raises(ValueError, match="row-sharded"):
            route_dist_operator(UNSHARD, mesh, s_max=8)

    def test_partition_operator_type_error(self, port):
        assert get(port, "refuse_object")["type"] == "TypeError"

    def test_general_sparsity_partitions_and_solves(self, port, mesh):
        """JAX routes a windowed non-DIA matrix to its PELL engine; the port
        gives the same format, partitions it as a DistPell (halo s_max x
        bandwidth 60) and ``dist_solve_auto`` solves it with JAX's route,
        label, restart count and eigenvalues."""
        _, fmt, _ = route_dist_operator(GENERAL, mesh, s_max=4)
        assert get(port, "route_general")["format"] == fmt == "pell"
        part = get(port, "part_general")
        assert part["type"] is None and part["op"] == "DistPell" and part["halo"] == 240
        out = get(port, "solve_general")
        res_j = dist_solve_auto(GENERAL, np.ones(1024), 32, mesh, LanczosConfig(**GEN_CFG))
        assert out["format"] == res_j.route.format == "pell"
        assert out["solver"] == res_j.solver and out["converged"] and res_j.converged
        assert out["n_restarts"] == res_j.n_restarts
        got = np.sort(out["eigs"])[::-1]
        np.testing.assert_allclose(got, np.sort(res_j.eigs)[::-1], rtol=1e-10)
        np.testing.assert_allclose(got, _oracle(GENERAL, 4), rtol=1e-8)


class TestDistSolveAuto:
    def test_banded_converges(self, port, mesh):
        out = get(port, "solve")
        assert out["converged"] and out["solver"] == "dist_restarted_ca_lanczos"
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], _oracle(A_SOLVE, 4), rtol=1e-8)
        res_j = dist_solve_auto(A_SOLVE, np.ones(1024), 32, mesh,
                                LanczosConfig(n_wanted=4, s=4, tol=1e-9))
        assert out["solver"] == res_j.solver and out["n_restarts"] == res_j.n_restarts
        np.testing.assert_allclose(np.sort(out["eigs"]), np.sort(res_j.eigs), rtol=1e-10)

    def test_two_stage_polish(self, port):
        outs = [get(port, "polish", k) for k in range(P)]
        out = outs[0]
        assert out["converged"] and out["solver"].endswith("+polish6")
        assert len(out["eigs"]) == 4 and out["polish_resid"] is not None
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], _oracle(A_POL, 4), rtol=1e-9)
        # every rank returns the same numbers; rank 0 alone holds Q_conv
        for o in outs[1:]:
            np.testing.assert_array_equal(o["eigs"], out["eigs"])
            np.testing.assert_array_equal(o["polish_resid"], out["polish_resid"])
            assert o["Q"] is None and o["solver"] == out["solver"]
        assert out["Q"].shape == (1024, 4)

    def test_irl_first_rung_matches_jax(self, port, mesh):
        """chip_smoke.py phase J(c) at 4,096 rows: the probe finds the
        cluster, the IRL is the first rung, and the port's ladder, restart
        count and polished eigenvalues are the JAX package's."""
        out = get(port, "irl_first")
        res_j = dist_solve_auto(A_CL, np.ones(4096), 48, mesh, LanczosConfig(**CL_CFG),
                                polish=10, over_lock=3)
        assert out["solver"] == res_j.solver == "dist_impl_restarted_ca_lanczos+polish10"
        assert out["converged"] and not out["escalated"] and not res_j.escalated
        assert out["n_restarts"] == res_j.n_restarts
        got = np.sort(out["eigs"])[::-1]
        np.testing.assert_allclose(got, np.sort(res_j.eigs)[::-1], rtol=1e-10)
        np.testing.assert_allclose(got, EXACT_CL, rtol=1e-10)
        assert out["Q"].shape == (4096, 10) and np.isfinite(out["Q"]).all()

    def test_reordered_general_sparsity(self, port):
        out = get(port, "reordered")
        assert out["converged"] and out["perm"] is not None
        q = out["Q"][:, 0] / np.linalg.norm(out["Q"][:, 0])
        lam = q @ (SCAT_R @ q)
        assert np.linalg.norm(SCAT_R @ q - lam * q) < 1e-7
        assert abs(lam - np.max(out["eigs"])) < 1e-9


class TestDistRitzVectorAlignment:
    def test_clustered_true_residuals(self, port):
        out = get(port, "align")
        assert out["converged"] and out["n_restarts"] < 30
        Q = out["Q"]
        for j in range(2):
            q = Q[:, j] / np.linalg.norm(Q[:, j])
            lam = q @ (A_ALIGN @ q)
            assert np.linalg.norm(A_ALIGN @ q - lam * q) < 1e-7, (j, lam)


class TestDistMixedPrecision:
    def test_dist_ca_lanczos_mp_T_accuracy(self, port):
        t64, t32, tmp = (get(port, c)["T"] for c in ("mp64", "mp32", "mpmp"))
        err32 = np.max(np.abs(t32 - t64))
        errmp = np.max(np.abs(tmp - t64))
        assert errmp < err32
        assert errmp < 1e-4, (errmp, err32)


class TestPolishWithoutSolveOperator:
    def test_polish_block_takes_the_device(self):
        """``f64_operator(raw, None, ...)``: no solve operator, so the
        device comes from the argument (it used to read A_solve.device and
        raise AttributeError)."""
        from ca_lanczos_tpu_torch.solvers.polish import f64_operator

        from scipy.sparse.linalg import eigsh

        _, V = eigsh(A_POL, k=4, which="LA")
        Q = np.linalg.qr(V + 1e-3 * np.random.default_rng(4).standard_normal((1024, 4)))[0]
        w, resid, Qp = f64_operator(A_POL, None, None, "largest",
                                    device="cpu")[0](torch.as_tensor(Q), 6, 4)
        assert Qp.device.type == "cpu" and Qp.shape == (1024, 4)
        np.testing.assert_allclose(np.sort(w)[::-1], _oracle(A_POL, 4), rtol=1e-9)
        assert np.all(np.isfinite(resid))


class TestSolveCliMesh:
    @pytest.mark.parametrize("hosts", [0, 2])
    def test_solve_mtx_mesh(self, tmp_path, hosts):
        """``solve --mesh 4`` (``--hosts 2``: the 2 x 2 hierarchical mesh)
        routes through dist_solve_auto on 4 gloo ranks; eigenvalues as the
        JAX CLI test's (rtol 1e-7 to the dense oracle)."""
        from ca_lanczos_tpu_torch.__main__ import main

        n = 512
        d = np.linspace(1.0, 40.0, n)
        a = sp.diags([d, 0.05 * np.ones(n - 1), 0.05 * np.ones(n - 1)], [0, -1, 1])
        path = str(tmp_path / "band.mtx")
        save_mtx(path, a)
        out = str(tmp_path / "rec.json")
        argv = ["--device", "cpu", "solve", "--mtx", path, "--n-wanted", "3",
                "--max-lanczos", "24", "--s", "4", "--mesh", "4", "--out", out]
        assert main(argv + (["--hosts", str(hosts)] if hosts else [])) == 0
        rec = json.loads(open(out).read().strip())
        assert rec["converged"] and rec["solver"].startswith("dist_")
        exact = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:3]
        np.testing.assert_allclose(rec["eigs"][:3], exact, rtol=1e-7)
