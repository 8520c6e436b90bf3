"""PyTorch port, the interleaved engine of ``parallel.DistDia`` (K3's
plain version on the CPU) on 4 gloo ranks: mirrors TestDistIlv and
TestIlvEngineDrivers of tests/test_ilv_route.py with their tolerances.
The references are the JAX package's natural-engine distributed powers
and ``dist_ca_lanczos`` on ``make_mesh(4)`` (the JAX tests' own
references), f64 oracles and planted spectra; the JAX interleaved engine
itself (Pallas interpret mode) is rerun only for the clustered IRL.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ca_lanczos_tpu.ops.spmv import DiaMatrix
from ca_lanczos_tpu.parallel import make_mesh
from ca_lanczos_tpu.parallel.distributed import DistDia, dist_matrix_powers
from ca_lanczos_tpu.parallel.driver import dist_ca_lanczos
from ca_lanczos_tpu_torch.config import LanczosConfig as TCfg
from ca_lanczos_tpu_torch.parallel import checks
from ca_lanczos_tpu_torch.parallel.runtime import spawn

P = 4
N = 8 * 1024  # n_local = 2048: a multiple of the 1024-row ghost depth
OFFS = (-1, 0, 1)


def _powers_inputs(seed):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((3, N)) * (0.3 if seed == 11 else 0.25)).astype(np.float32)
    x = rng.standard_normal(N).astype(np.float32)
    dg = (rng.standard_normal(4) * 0.1).astype(np.float32)
    sb = (rng.standard_normal(4) * 0.1).astype(np.float32)
    return data, x, dg, sb


POW = _powers_inputs(11)
CHAIN = _powers_inputs(21)


def _ca_inputs():
    rng = np.random.default_rng(31)
    off = (rng.standard_normal(N) * 0.05).astype(np.float32)
    data = np.zeros((3, N), np.float32)
    data[1] = np.linspace(0.5, 2.0, N)
    data[0, 1:] = off[:-1]
    data[2, :-1] = off[:-1]
    return data, rng.standard_normal(N).astype(np.float32)


CA_DATA, CA_R = _ca_inputs()
_rng = np.random.default_rng(12)
ENC_DATA = (_rng.standard_normal((3, N)) * 0.3).astype(np.float32)
ENC_X = _rng.standard_normal(N).astype(np.float32)


def _tridiag_f32(n, top=None, seed=7, off_scale=0.05):
    """f32 tridiagonal planes + the f64 matvec of the same matrix."""
    rng = np.random.default_rng(seed)
    off = (rng.standard_normal(n) * off_scale).astype(np.float32)
    data = np.zeros((3, n), np.float32)
    data[1] = np.linspace(1.0, 100.0, n)
    if top is not None:
        data[1, -len(top):] = top
    data[0, 1:] = off[:-1]
    data[2, :-1] = off[:-1]
    Ad = np.asarray(data, np.float64)

    def matvec(X):
        X = np.atleast_2d(X.T).T
        Y = Ad[1][:, None] * X
        Y[1:] += Ad[0][1:, None] * X[:-1]
        Y[:-1] += Ad[2][:-1, None] * X[1:]
        return Y

    return data, matvec


TRI, _ = _tridiag_f32(N)
R_ORTH = np.random.default_rng(5).standard_normal(N).astype(np.float32)
TOP = np.array([140, 150, 160, 170], np.float32)
TRI_TOP, MV_TOP = _tridiag_f32(N, top=TOP)
CLUSTER = np.array([169.4, 169.8, 170.0, 170.5], np.float32)
TRI_CL, MV_CL = _tridiag_f32(N, top=CLUSTER, seed=3)


def _flagship_f32(n):
    """The exp/flagship_10m.py recipe (planted top 10 over 1..90, 1e-3
    couplings) as f32 planes."""
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = np.linspace(95.0, 100.0, 10)
    off = np.random.default_rng(0).standard_normal(n) * 1e-3
    data = np.zeros((3, n), np.float32)
    data[0, 1:] = off[:-1]
    data[1] = d
    data[2, :-1] = off[:-1]
    return data


FLAG = _flagship_f32(65536)

SPECS = [
    ("enc", "ilv_roundtrip", dict(data=ENC_DATA, offsets=OFFS, x=ENC_X)),
    ("ca_nat", "ca_lanczos", dict(data=CA_DATA, offsets=OFFS, r=CA_R, s=4, steps=12)),
    ("ca_ilv", "ca_lanczos", dict(data=CA_DATA, offsets=OFFS, r=CA_R, s=4, steps=12,
                                  dist_format="ilv", want_Q=True)),
    ("rst", "restarted", dict(data=TRI_TOP, offsets=OFFS,
                              r=np.random.default_rng(11).standard_normal(N), max_lanczos=24,
                              cfg=TCfg(s=4, n_wanted=4, tol=1e-5, max_restarts=40),
                              dist_format="ilv")),
    ("irl", "irl", dict(data=TRI_TOP, offsets=OFFS,
                        r=np.random.default_rng(13).standard_normal(N), max_lanczos=32,
                        n_wanted=4, s=4, tol=1e-5, max_restarts=30, dist_format="ilv")),
    ("irl_cluster", "irl", dict(data=TRI_CL, offsets=OFFS,
                                r=np.random.default_rng(17).standard_normal(N), max_lanczos=32,
                                n_wanted=4, s=4, tol=1e-6, max_restarts=40,
                                dist_format="ilv")),
]
for _fmt in ("dia", "ilv"):
    SPECS.append((f"flag_{_fmt}", "restarted", dict(
        data=FLAG, offsets=OFFS, r=np.ones(65536), max_lanczos=32,
        cfg=TCfg(n_wanted=13, s=8, tol=1e-4, max_restarts=60), dist_format=_fmt)))
for _per in (False, True):
    SPECS.append((f"pow{_per}", "ilv_powers", dict(
        data=POW[0], offsets=OFFS, x=POW[1], s=4, diag=POW[2], sub=POW[3], periodic=_per)))
    SPECS.append((f"chain{_per}", "ilv_chain", dict(
        data=CHAIN[0], offsets=OFFS, x=CHAIN[1], s=4, diag=CHAIN[2], sub=CHAIN[3], blocks=3,
        periodic=_per)))
for _o in ("full", "periodic", "selective"):
    SPECS.append((f"orth_{_o}", "ca_lanczos", dict(data=TRI, offsets=OFFS, r=R_ORTH, s=4,
                                                   steps=12, orth=_o, dist_format="ilv",
                                                   want_Q=True)))


@pytest.fixture(scope="module")
def port():
    return spawn(checks.run, P, "cpu", SPECS, threads=1, timeout=600)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(P)


def get(port, cid, rank=0):
    out = port[rank][cid]
    if isinstance(out, dict) and "__error__" in out:
        pytest.fail(f"rank {rank}, case {cid}:\n{out['__error__']}")
    return out


def _jdia(data):
    return DiaMatrix(data=jnp.asarray(data), offsets=OFFS)


def _scan(mesh, data, x, dg, sb, periodic):
    A = DistDia.from_dia(_jdia(data), mesh, s_max=4, periodic=periodic)
    return A, A.shard_vector(x, mesh), jnp.asarray(dg), jnp.asarray(sb)


class TestDistIlv:
    @pytest.mark.parametrize("periodic", [False, True])
    def test_dist_powers_interleaved_center(self, port, mesh, periodic):
        """dist_matrix_powers_ilv (per-rank interleaved state, (J, 128)
        edge exchange) matches the JAX natural distributed powers after
        decode."""
        A, xs, dg, sb = _scan(mesh, *POW, periodic)
        V = np.asarray(dist_matrix_powers(A, xs, 4, dg, sb, mesh))[:N, 1:]
        np.testing.assert_allclose(get(port, f"pow{periodic}").T, V, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("periodic", [False, True])
    def test_padded_domain_chain(self, port, mesh, periodic):
        """Three chained ilv_padded_powers calls in the padded domain (ghosts
        refreshed per block, ``last`` chained) match s-step chains of the
        natural path."""
        A, v, dg, sb = _scan(mesh, *CHAIN, periodic)
        for _ in range(3):
            v = dist_matrix_powers(A, v, 4, dg, sb, mesh)[:, 4]
        np.testing.assert_allclose(get(port, f"chain{periodic}"), np.asarray(v)[:N],
                                   rtol=3e-5, atol=3e-5)

    def test_dist_ca_lanczos_ilv_engine(self, port, mesh):
        """The interleaved driver's Ritz values match the natural layout's
        (the port's and JAX's) to f32 summation-order drift; the decoded
        basis is orthonormal and satisfies the Lanczos relation."""
        T1 = get(port, "ca_ilv")["T"]
        res_j = dist_ca_lanczos(_jdia(CA_DATA), CA_R, 4, 12, mesh)
        for T0 in (get(port, "ca_nat")["T"], res_j.T):
            np.testing.assert_allclose(np.linalg.eigvalsh(T1), np.linalg.eigvalsh(T0),
                                       rtol=5e-4, atol=1e-4)
        Q = get(port, "ca_ilv")["Q"]
        m = T1.shape[0]
        np.testing.assert_allclose(Q.T @ Q, np.eye(m), atol=2e-3)
        Ad = np.asarray(CA_DATA, np.float64)
        AQ = Ad[1][:, None] * Q
        AQ[1:] += Ad[0][1:, None] * Q[:-1]
        AQ[:-1] += Ad[2][:-1, None] * Q[1:]
        assert np.max(np.abs(AQ[:, : m - 4] - Q @ T1[:, : m - 4])) < 2e-3

    def test_dist_ilv_encode_roundtrip(self, port):
        out = get(port, "enc")
        np.testing.assert_array_equal(out["decoded"], ENC_X)
        np.testing.assert_array_equal(out["entry_exit"], ENC_X)  # shard_entry -> gather
        assert out["m_pad"] == N // P + 2 * 1024


class TestIlvEngineDrivers:
    @pytest.mark.parametrize("orth", ["full", "periodic", "selective"])
    def test_dist_ca_lanczos_ilv_all_orth(self, port, mesh, orth):
        res_j = dist_ca_lanczos(_jdia(TRI), R_ORTH, 4, 12, mesh, orth=orth)
        out = get(port, f"orth_{orth}")
        np.testing.assert_allclose(np.linalg.eigvalsh(out["T"]), np.linalg.eigvalsh(res_j.T),
                                   rtol=5e-4, atol=5e-4)
        Q = out["Q"]
        np.testing.assert_allclose(Q.T @ Q, np.eye(out["T"].shape[0]), atol=2e-3)

    def test_dist_restarted_ilv(self, port):
        out = get(port, "rst")
        assert out["converged"]
        Q = out["Q"]
        assert Q.shape == (N, 4)
        order = np.argsort(out["eigs"])[::-1]
        for lam, j in zip(np.sort(out["eigs"])[::-1], order):
            q = Q[:, j] / np.linalg.norm(Q[:, j])
            assert np.linalg.norm(MV_TOP(q)[:, 0] - lam * q) < 1e-2, lam
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], np.sort(TOP)[::-1], rtol=1e-4)

    def test_dist_irl_ilv(self, port):
        out = get(port, "irl")
        assert out["converged"]
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], np.sort(TOP)[::-1], rtol=1e-4)
        assert out["Q"].shape[0] == N

    def test_dist_irl_ilv_clustered(self, port, mesh):
        import scipy.sparse.linalg as spla

        from ca_lanczos_tpu.parallel.dist_irl import dist_impl_restarted_ca_lanczos

        out = get(port, "irl_cluster")
        assert out["converged"]
        # the JAX driver on its own interleaved engine (Pallas interpret
        # mode), same inputs: f32 planes, so f32 rounding apart
        kw = dict(next(k for c, _, k in SPECS if c == "irl_cluster"))
        data, r, ml = kw.pop("data"), kw.pop("r"), kw.pop("max_lanczos")
        del kw["offsets"]
        res_j = dist_impl_restarted_ca_lanczos(_jdia(data), r, ml, mesh, **kw)
        assert res_j.converged and out["n_restarts"] == res_j.n_restarts
        np.testing.assert_allclose(np.sort(out["eigs"]), np.sort(np.asarray(res_j.eigs)),
                                   rtol=1e-6)
        lo = spla.LinearOperator((N, N), matvec=lambda v: MV_CL(v)[:, 0])
        oracle = np.sort(spla.eigsh(lo, k=4, which="LA", return_eigenvectors=False))[::-1]
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], oracle, rtol=2e-4)
        Q, d = out["Q"], out["eigs"]
        for j in range(4):
            q = Q[:, j] / np.linalg.norm(Q[:, j])
            assert np.linalg.norm(MV_CL(q)[:, 0] - d[j] * q) < 1e-2, d[j]

    def test_restarted_flagship_recipe_both_engines(self, port):
        """Path A's settings on the flagship recipe at 65,536 f32 rows: the
        interleaved engine converges like the natural one.  Its QR sees the
        centre rows alone (``step.orth_qr``); a Householder QR of the
        padded state left eps*cond noise in the ghost rows, which the
        ghost refresh dropped, and this solve stalled at max_restarts."""
        nat, ilv = get(port, "flag_dia"), get(port, "flag_ilv")
        assert nat["converged"] and ilv["converged"]
        np.testing.assert_allclose(np.sort(ilv["eigs"])[::-1][:10],
                                   np.sort(nat["eigs"])[::-1][:10], rtol=1e-4)
