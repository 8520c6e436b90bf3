"""PyTorch port, the second slice of ``ca_lanczos_tpu_torch.parallel`` on 4
gloo ranks against the JAX package on ``make_mesh(4)``: the general
operators DistEll, DistPell (K4 on each rank's window; its plain version
on the CPU) and DistBsr, ``partition_operator``'s branches and refusals,
the drivers on them and ``dist_solve_auto``'s general-sparsity routes.

Mirrors tests/test_parallel.py ``TestDistEll``, ``TestDistEllDriver``,
``TestDistRestartedEll`` and ``TestDistPell``, tests/test_bsr.py
``TestDistBsr`` (not its million-row case, which is marked slow there)
and tests/test_dist_auto.py ``test_reordered_general_sparsity``, with the
JAX tests' tolerances; each case also runs JAX's own distributed function
(its PELL kernel in Pallas interpret mode) on the same numpy inputs.
Also: ``ell_shard_planes`` equals JAX's element for element; JAX's own
partitions carried across (``utils.interop.dist_operator_from_numpy``)
give the port's powers; the IRL on an f32 DistPell takes JAX's restart
count; one exchange per s-step call; a small copy of chip_smoke.py phase
K(a) (the PELL oracle recipe, routed with ``max_diags=16``).

The port's ranks start once per module (``runtime.spawn`` of
``parallel.checks.run``) and run every case; each test reads its case's
answer from rank 0 and computes the JAX side here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from ca_lanczos_tpu.config import Basis, LanczosConfig, Orth
from ca_lanczos_tpu.ops.bsr import BsrMatrix
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers, matrix_powers_from_B
from ca_lanczos_tpu.ops.spmv import EllMatrix
from ca_lanczos_tpu.parallel import (
    DistBsr,
    DistEll,
    DistPell,
    dist_bsr_matrix_powers,
    dist_ca_lanczos,
    dist_ell_matrix_powers,
    dist_pell_matrix_powers,
    dist_solve_auto,
    make_mesh,
)
from ca_lanczos_tpu.parallel.dist_irl import dist_impl_restarted_ca_lanczos
from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos
from ca_lanczos_tpu.parallel.step import newton_coeffs
from ca_lanczos_tpu.solvers.ca_lanczos import build_basis_matrix, ca_lanczos
from ca_lanczos_tpu.utils.matrices import harmonic_oscillator, laplacian_2d
from ca_lanczos_tpu_torch.config import LanczosConfig as TCfg
from ca_lanczos_tpu_torch.parallel import checks
from ca_lanczos_tpu_torch.parallel.runtime import spawn
from tests.test_torch_pell import pin_encoder


@pytest.fixture(autouse=True, scope="module")
def _jax_native_encoder():
    """JAX's PELL encoder on its native path, as the port's (``pin_encoder``):
    restart counts are compared on f32 DistPell planes encoded by each
    package."""
    with pytest.MonkeyPatch.context() as mp:
        pin_encoder(mp, "native")
        yield


P = 4


def _planes(E):
    return np.asarray(E.vals), np.asarray(E.cols)


def _ell_lap2d():
    """tests/test_parallel.py's 8 x 64 Laplacian as a JAX EllMatrix (band
    width 8: halo s*8 <= 32 < 128 rows a shard)."""
    return EllMatrix.from_dense(np.asarray(laplacian_2d(8, 64).to_dense()))


def _random_banded(n, bw, nnz_per_row, seed):
    """TestDistPell._random_banded_ell's matrix (scipy CSR, symmetric)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        k = min(nnz_per_row, hi - lo)
        cs = rng.choice(np.arange(lo, hi), size=k, replace=False)
        rows += [i] * k
        cols += list(cs)
        vals += list(rng.standard_normal(k))
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    return (a + a.T).tocsr()


def _block_laplacian(n_blocks, bs, seed):
    """tests/test_bsr.py's SPD block tridiagonal with dense (bs, bs) tiles."""
    rng = np.random.default_rng(seed)
    n = n_blocks * bs
    dense = np.zeros((n, n))
    for i in range(n_blocks):
        B = rng.standard_normal((bs, bs)) * 0.1
        dense[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = B @ B.T + 4 * np.eye(bs)
        if i + 1 < n_blocks:
            C = rng.standard_normal((bs, bs)) * 0.2
            dense[i * bs:(i + 1) * bs, (i + 1) * bs:(i + 2) * bs] = C
            dense[(i + 1) * bs:(i + 2) * bs, i * bs:(i + 1) * bs] = C.T
    return dense


def _bsr_planted():
    """TestDistBsr.test_dist_restarted_converges's planted block operator."""
    n = 512 * 4
    d = np.linspace(1.0, 50.0, n)
    d[-3:] = [80.0, 85.0, 90.0]
    return sp.diags([np.full(n - 1, 1e-2), d, np.full(n - 1, 1e-2)], [-1, 0, 1]).tocsr()


def pell_operator(n, bw=8, k=4, seed=0):
    """chip_smoke.py's ``pell_operator`` (exp/pell_10m_e2e.py:43-56) at a
    small n: random columns inside a width-8 band over a separated top."""
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


def _band(n, d, off=0.05):
    o = off * np.ones(n - 1)
    return sp.diags([d, o, o], [0, -1, 1]).tocsr()


ELL2D = _ell_lap2d()
ELL2D_OP = ("ell",) + _planes(ELL2D)
N2D = 512
X5 = np.random.default_rng(5).standard_normal(N2D)
Q6 = np.random.default_rng(6).standard_normal(N2D)
RB = {seed: EllMatrix.from_scipy(_random_banded(512, 8, 5, seed)) for seed in (3, 4, 5)}
X7 = np.random.default_rng(7).standard_normal(512)
Q8 = np.random.default_rng(8).standard_normal(512)
X9 = np.random.default_rng(9).standard_normal(512)
RB5_32 = EllMatrix(vals=jnp.asarray(np.asarray(RB[5].vals), jnp.float32), cols=RB[5].cols)
BSR192 = _block_laplacian(192, 4, 2)
BSR256 = _block_laplacian(256, 4, 4)
X_BSR = np.random.default_rng(3).standard_normal(768)
R_BSR = np.random.default_rng(5).standard_normal(1024)
BSR_PLANTED = _bsr_planted()
R_PLANTED = np.random.default_rng(6).standard_normal(2048)
PELL_OP = pell_operator(4096).astype(np.float32)
PELL_EXACT = np.sort(np.linalg.eigvalsh(PELL_OP.astype(np.float64).toarray()))[::-1][:4]
PELL_CFG = dict(n_wanted=4, s=8, tol=1e-4, max_restarts=200)
_d = np.linspace(1.0, 2.0, 1024)
_d[-1] = 3.0
_rng = np.random.default_rng(3)
_p = _rng.permutation(1024)
SCAT = sp.csr_matrix(_band(1024, _d, off=0.01)[_p][:, _p])
R_SCAT = _rng.standard_normal(1024)
CFG_RST_ELL = dict(s=4, basis="newton", orth="full", n_wanted=4, tol=1e-9)
CFG_RST_PELL = dict(s=4, basis="newton", orth="local", n_wanted=4, tol=1e-8)
IRL32 = dict(max_lanczos=32, n_wanted=3, s=4, tol=1e-5, max_restarts=60)


def _bsr_op(dense, bs=4):
    B = BsrMatrix.from_dense(dense, block_size=bs)
    return B, ("bsr", np.asarray(B.vals), np.asarray(B.cols))


def _bk(A, q, s):
    q = jnp.asarray(q)
    return np.asarray(build_basis_matrix(A, q / jnp.linalg.norm(q), s, Basis.NEWTON))


def _jax_part(D):
    """The stacked numpy planes and statics of a JAX distributed operator."""
    fields = {"vals", "cols", "lidx", "cbase", "span_row"}
    out = {k: np.asarray(getattr(D, k)) for k in fields if hasattr(D, k)}
    for k in ("halo", "halo_b", "n", "m", "tile", "k_slots", "sw", "n_win", "periodic",
              "s_max"):
        if hasattr(type(D), "__dataclass_fields__") and k in D.__dataclass_fields__:
            out[k] = getattr(D, k)
    return out


def _specs(mesh):
    bk_ell = _bk(ELL2D, Q6, 4)
    dg_e, sb_e = newton_coeffs(bk_ell)
    bk_pell = _bk(RB[4], Q8, 4)
    dg_p, sb_p = newton_coeffs(bk_pell)
    _, bsr192 = _bsr_op(BSR192)
    _, bsr256 = _bsr_op(BSR256)
    _, bsr_pl = _bsr_op(BSR_PLANTED.toarray())
    rb = {k: ("ell",) + _planes(v) for k, v in RB.items()}
    specs = [
        ("ell_newton", "gen_powers", dict(op=ELL2D_OP, x=Q6, s=4, diag=dg_e, sub=sb_e)),
        ("ell_jaxpart", "gen_powers", dict(
            op=None, x=X5, s=4, jax_part=_jax_part(DistEll.from_ell(ELL2D, mesh, s_max=4)))),
        ("pell_newton", "gen_powers", dict(op=rb[4], x=Q8, s=4, diag=dg_p, sub=sb_p,
                                           dist_format="pell")),
        ("pell_f32_f64", "gen_powers", dict(op=("ell",) + _planes(RB5_32), x=X9, s=2,
                                            dist_format="pell", state="float64")),
        ("pell_jaxpart", "gen_powers", dict(
            op=None, x=X7, s=4, jax_part=_jax_part(DistPell.from_ell(RB[3], mesh, s_max=4)))),
        ("ell_driver", "ca_lanczos", dict(op=ELL2D_OP, r=np.ones(N2D), s=4, steps=24)),
        ("pell_driver", "ca_lanczos", dict(op=ELL2D_OP, r=np.ones(N2D), s=4, steps=24,
                                           dist_format="pell")),
        ("ell_restarted", "restarted", dict(op=ELL2D_OP, r=np.ones(N2D), max_lanczos=32,
                                            cfg=TCfg(**CFG_RST_ELL))),
        ("pell_restarted", "restarted", dict(op=ELL2D_OP, r=np.ones(N2D), max_lanczos=32,
                                             cfg=TCfg(**CFG_RST_PELL), dist_format="pell")),
        ("pell_irl32", "irl", dict(op=("ell",) + _planes(RB5_32), r=np.ones(512),
                                   dist_format="pell", **IRL32)),
        ("bsr_powers", "gen_powers", dict(op=bsr192, x=X_BSR, s=4)),
        ("bsr_jaxpart", "gen_powers", dict(op=None, x=X_BSR, s=4, jax_part=_jax_part(
            DistBsr.from_bsr(BsrMatrix.from_dense(BSR192, block_size=4), mesh, s_max=4)))),
        ("bsr_driver", "ca_lanczos", dict(op=bsr256, r=R_BSR, s=4, steps=12)),
        ("bsr_restarted", "restarted", dict(op=bsr_pl, r=R_PLANTED, max_lanczos=16,
                                            cfg=TCfg(s=4, n_wanted=3, tol=1e-7,
                                                     max_restarts=30))),
        ("bsr_spmv", "gen_spmv", dict(op=bsr192, x=X_BSR)),
        ("ell_spmv", "gen_spmv", dict(op=rb[3], x=X7)),
        ("pell_spmv", "gen_spmv", dict(op=rb[3], x=X7, dist_format="pell")),
        ("comm_ell", "comm_gen_powers", dict(op=rb[3], s=4)),
        ("comm_pell", "comm_gen_powers", dict(op=rb[3], s=4, dist_format="pell")),
        ("comm_bsr", "comm_gen_powers", dict(op=bsr192, s=4)),
        ("part_ell", "partition", dict(a=_random_banded(512, 8, 5, 3))),
        ("part_pell", "partition", dict(a=_random_banded(512, 8, 5, 3), dist_format="pell")),
        ("part_ell_ilv", "partition", dict(a=_random_banded(512, 8, 5, 3), dist_format="ilv")),
        ("part_bsr", "partition", dict(a=sp.csr_matrix(BSR192), kind="bsr")),
        ("part_bsr_ilv", "partition", dict(a=sp.csr_matrix(BSR192), kind="bsr",
                                           dist_format="ilv")),
        ("part_bsr_pell", "partition", dict(a=sp.csr_matrix(BSR192), kind="bsr",
                                            dist_format="pell")),
        ("auto_pell", "solve_auto", dict(a=PELL_OP, r=np.ones(4096), max_lanczos=32,
                                         cfg=TCfg(**PELL_CFG), max_diags=16)),
        ("auto_reordered", "solve_auto", dict(a=SCAT, r=R_SCAT, max_lanczos=24,
                                              cfg=TCfg(n_wanted=1, s=4, tol=1e-9))),
    ]
    for s in (1, 2, 4):
        specs.append((f"ell_s{s}", "gen_powers", dict(op=ELL2D_OP, x=X5, s=s)))
        specs.append((f"pell_s{s}", "gen_powers", dict(op=rb[3], x=X7, s=s,
                                                       dist_format="pell")))
    return specs


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(P)


@pytest.fixture(scope="module")
def port(mesh):
    return spawn(checks.run, P, "cpu", _specs(mesh), threads=1, timeout=600)


def get(port, cid, rank=0):
    out = port[rank][cid]
    if isinstance(out, dict) and "__error__" in out:
        pytest.fail(f"rank {rank}, case {cid}:\n{out['__error__']}")
    return out


def _jax_powers(cls, fn, A, mesh, x, s, diag=None, sub=None, **kw):
    Ad = cls.from_ell(A, mesh, s_max=s, **kw) if cls is not DistBsr else cls.from_bsr(
        A, mesh, s_max=s)
    z = jnp.zeros(s)
    dg = z if diag is None else jnp.asarray(diag)
    sb = z if sub is None else jnp.asarray(sub)
    return np.asarray(fn(Ad, Ad.shard_vector(x, mesh), s, dg, sb, mesh))[: A.n]


class TestShardPlanes:
    @pytest.mark.parametrize("case", ["lap2d", "banded", "uneven", "periodic"])
    def test_equals_jax_element_for_element(self, case):
        """The port's host partition is JAX's, bit for bit, for every
        shard: values, window-local columns, halo and n."""
        import torch

        from ca_lanczos_tpu.parallel.dist_ell import ell_shard_planes as jplanes
        from ca_lanczos_tpu_torch.ops.spmv import EllMatrix as TEll
        from ca_lanczos_tpu_torch.parallel.dist_ell import ell_shard_planes as tplanes

        periodic = case == "periodic"
        A, s_max = {"lap2d": (ELL2D, 4), "banded": (RB[3], 2),
                    "uneven": (EllMatrix.from_scipy(_random_banded(509, 4, 3, 1)), 3),
                    "periodic": (harmonic_oscillator(512)[0], 4)}[case]
        want = jplanes(A, P, s_max, periodic)
        got = tplanes(TEll(vals=torch.as_tensor(np.array(A.vals)),
                           cols=torch.as_tensor(np.asarray(A.cols), dtype=torch.int64)),
                      P, s_max, periodic)
        assert got[2:] == want[2:]
        for g, w in zip(got[:2], want[:2]):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


class TestDistEll:
    @pytest.mark.parametrize("s", [1, 2, 4])
    def test_matches_single_chip(self, port, mesh, s):
        out = get(port, f"ell_s{s}")
        assert out["type"] == "DistEll" and out["halo"] == s * 8
        V_ref = np.asarray(matrix_powers(ELL2D, jnp.asarray(X5), s, None, Basis.MONOMIAL))
        np.testing.assert_allclose(out["V"], V_ref, rtol=1e-11, atol=1e-9)
        V_j = _jax_powers(DistEll, dist_ell_matrix_powers, ELL2D, mesh, X5, s)
        np.testing.assert_allclose(out["V"], V_j, rtol=1e-11, atol=1e-9)

    def test_newton_coeffs(self, port, mesh):
        Bk = _bk(ELL2D, Q6, 4)
        dg, sb = newton_coeffs(Bk)
        out = get(port, "ell_newton")
        q = jnp.asarray(Q6)
        V_ref = np.asarray(matrix_powers_from_B(ELL2D, q, Bk))
        np.testing.assert_allclose(out["V"], V_ref, rtol=1e-11, atol=1e-9)
        V_j = _jax_powers(DistEll, dist_ell_matrix_powers, ELL2D, mesh, Q6, 4, dg, sb)
        np.testing.assert_allclose(out["V"], V_j, rtol=1e-11, atol=1e-9)

    def test_jax_partition_carried_across(self, port):
        """JAX's own DistEll shards, carried into the port, give the
        port's powers."""
        np.testing.assert_allclose(get(port, "ell_jaxpart")["V"], get(port, "ell_s4")["V"],
                                   rtol=1e-13, atol=1e-12)


class TestDistEllDriver:
    def test_ell_driver_parity(self, port, mesh):
        out = get(port, "ell_driver")
        r = jnp.ones((N2D,), jnp.float64)
        res_d = dist_ca_lanczos(ELL2D, r, 4, 24, mesh, basis=Basis.MONOMIAL)
        res_1 = ca_lanczos(ELL2D, r, 4, 24, basis=Basis.MONOMIAL, orth=Orth.LOCAL)
        d = np.sort(np.linalg.eigvalsh(out["T"]))
        assert out["op"] == "DistEll"
        np.testing.assert_allclose(d, np.sort(np.linalg.eigvalsh(res_1.T)), rtol=1e-8,
                                   atol=1e-8)
        np.testing.assert_allclose(d, np.sort(np.linalg.eigvalsh(res_d.T)), rtol=1e-8,
                                   atol=1e-8)


def _lap2d_top(k):
    iv = np.pi * np.arange(1, 9) / 9
    jv = np.pi * np.arange(1, 65) / 65
    return np.sort(np.add.outer(2 - 2 * np.cos(iv), 2 - 2 * np.cos(jv)).ravel())[::-1][:k]


class TestDistRestartedEll:
    def test_general_sparsity_flagship(self, port, mesh):
        out = get(port, "ell_restarted")
        res_j = dist_restarted_ca_lanczos(ELL2D, np.ones(N2D), 32, mesh,
                                          LanczosConfig(**CFG_RST_ELL))
        assert out["converged"] and res_j.converged
        got = np.sort(out["eigs"])[::-1]
        np.testing.assert_allclose(got, _lap2d_top(4), rtol=1e-8)
        np.testing.assert_allclose(got, np.sort(res_j.eigs)[::-1], rtol=1e-8)


class TestDistPell:
    @pytest.mark.parametrize("s", [1, 2, 4])
    def test_matches_single_chip(self, port, mesh, s):
        out = get(port, f"pell_s{s}")
        assert out["type"] == "DistPell" and out["halo"] == s * 8
        V_ref = np.asarray(matrix_powers(RB[3], jnp.asarray(X7), s, None, Basis.MONOMIAL))
        np.testing.assert_allclose(out["V"], V_ref, rtol=1e-11, atol=1e-9)
        V_j = _jax_powers(DistPell, dist_pell_matrix_powers, RB[3], mesh, X7, s)
        np.testing.assert_allclose(out["V"], V_j, rtol=1e-11, atol=1e-9)

    def test_newton_coeffs(self, port, mesh):
        Bk = _bk(RB[4], Q8, 4)
        dg, sb = newton_coeffs(Bk)
        out = get(port, "pell_newton")
        V_ref = np.asarray(matrix_powers_from_B(RB[4], jnp.asarray(Q8), Bk))
        np.testing.assert_allclose(out["V"], V_ref, rtol=1e-11, atol=1e-9)
        V_j = _jax_powers(DistPell, dist_pell_matrix_powers, RB[4], mesh, Q8, 4, dg, sb)
        np.testing.assert_allclose(out["V"], V_j, rtol=1e-11, atol=1e-9)

    def test_f64_state_through_f32_planes(self, port, mesh):
        """f32 planes, f64 driver state: K4's plain version runs in f32 at
        the seam and the powers return in f64, as in the JAX package."""
        out = get(port, "pell_f32_f64")
        assert out["planes"] == "float32" and out["dtype"] == "float64"
        V_ref = np.asarray(matrix_powers(RB5_32, jnp.asarray(X9, jnp.float32), 2, None,
                                         Basis.MONOMIAL))
        np.testing.assert_allclose(out["V"], V_ref, rtol=2e-4, atol=2e-4)
        V_j = _jax_powers(DistPell, dist_pell_matrix_powers, RB5_32, mesh, X9, 2)
        np.testing.assert_allclose(out["V"], V_j, rtol=2e-4, atol=2e-4)

    def test_jax_partition_carried_across(self, port):
        """JAX's DistPell shards (padded to common statics) carried into the
        port: the same powers as the port's own per-rank encoding."""
        np.testing.assert_allclose(get(port, "pell_jaxpart")["V"], get(port, "pell_s4")["V"],
                                   rtol=1e-12, atol=1e-11)

    def test_driver_parity(self, port, mesh):
        out = get(port, "pell_driver")
        r = jnp.ones((N2D,), jnp.float64)
        res_d = dist_ca_lanczos(ELL2D, r, 4, 24, mesh, basis=Basis.MONOMIAL,
                                dist_format="pell")
        res_1 = ca_lanczos(ELL2D, r, 4, 24, basis=Basis.MONOMIAL, orth=Orth.LOCAL)
        d = np.sort(np.linalg.eigvalsh(out["T"]))
        assert out["op"] == "DistPell"
        np.testing.assert_allclose(d, np.sort(np.linalg.eigvalsh(res_1.T)), rtol=1e-8,
                                   atol=1e-8)
        np.testing.assert_allclose(d, np.sort(np.linalg.eigvalsh(res_d.T)), rtol=1e-8,
                                   atol=1e-8)
        np.testing.assert_allclose(d, np.sort(np.linalg.eigvalsh(get(port, "ell_driver")["T"])),
                                   rtol=1e-8, atol=1e-8)

    def test_restarted_flagship_pell(self, port, mesh):
        out = get(port, "pell_restarted")
        res_j = dist_restarted_ca_lanczos(ELL2D, np.ones(N2D), 32, mesh,
                                          LanczosConfig(**CFG_RST_PELL), dist_format="pell")
        assert out["converged"] and res_j.converged
        exact = np.sort(np.linalg.eigvalsh(np.asarray(ELL2D.to_dense())))[::-1][:4]
        got = np.sort(out["eigs"])[::-1]
        np.testing.assert_allclose(got, exact, rtol=1e-9)
        np.testing.assert_allclose(got, np.sort(res_j.eigs)[::-1], rtol=1e-9)

    def test_irl_f32_planes_takes_jax_restart_count(self, port, mesh):
        """The IRL on a DistPell of f32 planes with an f64 start: f64 state,
        K4 in f32 at the seam; the restart count is JAX's."""
        out = get(port, "pell_irl32")
        res_j = dist_impl_restarted_ca_lanczos(RB5_32, np.ones(512), mesh=mesh,
                                               dist_format="pell", **IRL32)
        assert out["converged"] and res_j.converged
        assert out["n_restarts"] == res_j.n_restarts
        np.testing.assert_allclose(np.sort(out["eigs"]), np.sort(res_j.eigs), rtol=1e-5)


class TestDistBsr:
    def test_dist_matrix_powers_parity(self, port, mesh):
        out = get(port, "bsr_powers")
        assert out["type"] == "DistBsr" and out["halo"] == 4 * 4
        V = out["V"]
        np.testing.assert_allclose(V[:, 0], X_BSR)
        ref = X_BSR.copy()
        for k in range(1, 5):
            ref = BSR192 @ ref
            np.testing.assert_allclose(V[:, k], ref, rtol=1e-10, atol=1e-10)
        V_j = _jax_powers(DistBsr, dist_bsr_matrix_powers,
                          BsrMatrix.from_dense(BSR192, block_size=4), mesh, X_BSR, 4)
        np.testing.assert_allclose(V, V_j, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(get(port, "bsr_jaxpart")["V"], V, rtol=1e-13, atol=1e-12)

    def test_dist_ca_lanczos_parity(self, port, mesh):
        out = get(port, "bsr_driver")
        A = BsrMatrix.from_dense(BSR256, block_size=4)
        host = ca_lanczos(A, jnp.asarray(R_BSR), 4, 12)
        res_j = dist_ca_lanczos(A, R_BSR, 4, 12, mesh)
        d = np.linalg.eigvalsh(out["T"])
        assert out["op"] == "DistBsr"
        np.testing.assert_allclose(d, np.linalg.eigvalsh(np.asarray(host.T)), rtol=1e-8,
                                   atol=1e-8)
        np.testing.assert_allclose(d, np.linalg.eigvalsh(res_j.T), rtol=1e-8, atol=1e-8)

    def test_dist_restarted_converges(self, port, mesh):
        out = get(port, "bsr_restarted")
        A = BsrMatrix.from_scipy(BSR_PLANTED, block_size=4)
        res_j = dist_restarted_ca_lanczos(A, R_PLANTED, 16, mesh,
                                          LanczosConfig(s=4, n_wanted=3, tol=1e-7,
                                                        max_restarts=30))
        assert out["converged"] and res_j.converged
        got = np.sort(out["eigs"])[::-1]
        np.testing.assert_allclose(got, [90.0, 85.0, 80.0], rtol=1e-6)
        np.testing.assert_allclose(got, np.sort(res_j.eigs)[::-1], rtol=1e-6)

    def test_route_rejects_wrong_engines(self, port):
        for fmt in ("ilv", "pell"):
            out = get(port, f"part_bsr_{fmt}")
            assert out["type"] == "ValueError" and "not a BSR engine" in out["msg"]


class TestPartitionOperator:
    @pytest.mark.parametrize("cid,op", [("part_ell", "DistEll"), ("part_pell", "DistPell"),
                                        ("part_bsr", "DistBsr")])
    def test_branches_and_pass_through(self, port, cid, op):
        """EllMatrix -> DistEll ("auto") / DistPell ("pell"), BsrMatrix ->
        DistBsr, as JAX's partition_operator; a distributed operator
        passes through.  Halos: s_max x the (block) bandwidth."""
        out = get(port, cid)
        assert out["type"] is None and out["op"] == op and out["same"]
        assert out["halo"] == (4 * 4 if op == "DistBsr" else 4 * 8)
        assert out["n_local"] == (768 // P if op == "DistBsr" else 512 // P)

    def test_ell_refuses_ilv(self, port):
        out = get(port, "part_ell_ilv")
        assert out["type"] == "ValueError" and "EllMatrix" in out["msg"]

    @pytest.mark.parametrize("cid,dense", [("bsr_spmv", None), ("ell_spmv", 3),
                                           ("pell_spmv", 3)])
    def test_one_product(self, port, cid, dense):
        """The locking and true-residual product of the new operators:
        column 1 of their s = 1 powers."""
        if dense is None:
            want = BSR192 @ X_BSR
        else:
            want = np.asarray(RB[dense].to_dense()) @ X7
        np.testing.assert_allclose(get(port, cid), want, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("cid", ["comm_ell", "comm_pell", "comm_bsr"])
    def test_one_exchange_per_block(self, port, cid):
        """An s-step powers call costs one halo exchange: the interior
        ranks send halo rows each way, the edge ranks one way; no
        reduction."""
        for rank in range(P):
            c = get(port, cid, rank)
            assert c["exchanges"] == 1 and c["all_reduce"] == 0 and c["all_gather"] == 0
            sides = 1 if rank in (0, P - 1) else 2
            assert c["halo_elems"] == sides * c["halo"]


class TestDistSolveAutoGeneral:
    def test_pell_route_matches_jax(self, port, mesh):
        """chip_smoke.py phase K(a) at 4,096 rows: 17 diagonals fail the
        DIA test at max_diags=16, the route is "pell" (DistPell, K4's plain
        version here), and route, label, restarts and eigenvalues are JAX's
        dist_solve_auto's."""
        out = get(port, "auto_pell")
        res_j = dist_solve_auto(PELL_OP, np.ones(4096), 32, mesh, LanczosConfig(**PELL_CFG),
                                max_diags=16)
        assert out["format"] == res_j.route.format == "pell"
        assert out["solver"] == res_j.solver == "dist_restarted_ca_lanczos"
        assert out["converged"] and res_j.converged
        assert out["n_restarts"] == res_j.n_restarts
        got = np.sort(out["eigs"])[::-1]
        np.testing.assert_allclose(got, np.sort(res_j.eigs)[::-1], rtol=1e-5)
        np.testing.assert_allclose(got, PELL_EXACT, atol=1e-4 * PELL_EXACT[0])

    def test_reordered_general_sparsity(self, port, mesh):
        """tests/test_dist_auto.py's permuted band: RCM, then the solve;
        the Ritz vector decodes to the original order.  JAX's
        dist_solve_auto takes the same route and eigenvalue."""
        out = get(port, "auto_reordered")
        res_j = dist_solve_auto(SCAT, R_SCAT, 24, mesh, LanczosConfig(n_wanted=1, s=4,
                                                                      tol=1e-9))
        assert out["converged"] and out["perm"] is not None
        assert out["format"] == res_j.route.format
        np.testing.assert_array_equal(out["perm"], res_j.route.perm)
        q = out["Q"][:, 0] / np.linalg.norm(out["Q"][:, 0])
        lam = q @ (SCAT @ q)
        assert np.linalg.norm(SCAT @ q - lam * q) < 1e-7
        assert abs(lam - np.max(out["eigs"])) < 1e-9
        np.testing.assert_allclose(np.max(out["eigs"]), np.max(res_j.eigs), rtol=1e-10)
