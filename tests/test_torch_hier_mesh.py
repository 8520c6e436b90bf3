"""PyTorch port, the hierarchical (host x chip) mesh of
``parallel.make_hier_mesh`` on 4 gloo ranks as 2 x 2, against the flat
mesh of the same ranks, the JAX package and planted spectra (mirrors
tests/test_hier_mesh.py at 2 x 2): the two-level all-reduce equals the
flat one; the TSQR tree gathers R factors over the chip group and then
the host group; the halo ring crosses the host boundary only at its
pair; every engine reproduces the flat and single-card answers.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ca_lanczos_tpu.parallel import CHIP, HOST, DistDia, dist_matrix_powers, make_mesh, row_axes
from ca_lanczos_tpu.solvers.ca_lanczos import ca_lanczos
from ca_lanczos_tpu.utils.matrices import laplacian_1d
from ca_lanczos_tpu_torch.config import LanczosConfig as TCfg
from ca_lanczos_tpu_torch.parallel import checks
from ca_lanczos_tpu_torch.parallel.runtime import spawn

P, H, C = 4, 2, 2


def _lap32(n):
    return np.asarray(laplacian_1d(n, dtype=jnp.float32).data), (-1, 0, 1)


X_PSUM = np.arange(P * 3.0).reshape(P, 3)
X_QR = np.random.default_rng(0).standard_normal((P * 64, 5))
LAP1K = _lap32(P * 256)
R_POW = np.random.default_rng(0).standard_normal(P * 256).astype(np.float32)
R_NAT = np.random.default_rng(1).standard_normal(P * 256).astype(np.float32)
LAP4K = _lap32(P * 1024)
R_ILV = np.random.default_rng(2).standard_normal(P * 1024).astype(np.float32)
LAP2K = _lap32(P * 512)


def _planted(n, top):
    d = np.linspace(1.0, 10.0, n).astype(np.float32)
    d[-len(top):] = top
    return d[None, :]


TOP3 = np.array([20.0, 22.0, 25.0], np.float32)
TOP2 = np.array([20.0, 25.0], np.float32)

SPECS = []
for _h in (False, True):
    t = "hier" if _h else "flat"
    SPECS += [
        (f"psum_{t}", "psum", dict(X=X_PSUM, hier=_h)),
        (f"tsqr_{t}", "qr", dict(X=X_QR, hier=_h)),
        (f"pow_{t}", "powers", dict(data=LAP1K[0], offsets=LAP1K[1], x=R_POW, s=4, hier=_h)),
        (f"halo_{t}", "comm_powers", dict(data=LAP2K[0], offsets=LAP2K[1], s=4, s_max=4,
                                           hier=_h)),
    ]
SPECS += [
    ("ca_nat", "ca_lanczos", dict(data=LAP1K[0], offsets=LAP1K[1], r=R_NAT, s=4, steps=8,
                                  hier=True)),
    ("ca_ilv", "ca_lanczos", dict(data=LAP4K[0], offsets=LAP4K[1], r=R_ILV, s=4, steps=8,
                                  dist_format="ilv", hier=True)),
    ("rst", "restarted", dict(data=_planted(P * 128, TOP3), offsets=(0,),
                              r=np.random.default_rng(4).standard_normal(P * 128)
                              .astype(np.float32), max_lanczos=16,
                              cfg=TCfg(s=4, n_wanted=3, tol=1e-4, max_restarts=30), hier=True)),
    ("irl", "irl", dict(data=_planted(P * 128, TOP2), offsets=(0,),
                        r=np.random.default_rng(5).standard_normal(P * 128), max_lanczos=16,
                        n_wanted=2, s=4, tol=1e-5, max_restarts=30, hier=True)),
]


@pytest.fixture(scope="module")
def port():
    return spawn(checks.run, P, "cpu", SPECS, (H, C), threads=1, timeout=600)


def get(port, cid, rank=0):
    out = port[rank][cid]
    if isinstance(out, dict) and "__error__" in out:
        pytest.fail(f"rank {rank}, case {cid}:\n{out['__error__']}")
    return out


def _ritz_parity(T, data, r, s, steps, rtol=5e-4):
    from ca_lanczos_tpu.ops.spmv import DiaMatrix

    host = ca_lanczos(DiaMatrix(data=jnp.asarray(data), offsets=(-1, 0, 1)), jnp.asarray(r),
                      s, steps)
    np.testing.assert_allclose(np.linalg.eigvalsh(np.asarray(T, np.float64)),
                               np.linalg.eigvalsh(np.asarray(host.T, np.float64)),
                               rtol=rtol, atol=rtol)


class TestHierCollectives:
    def test_row_axes(self):
        from ca_lanczos_tpu_torch.parallel.mesh import Mesh
        from ca_lanczos_tpu_torch.parallel.mesh import row_axes as trow_axes

        flat = Mesh(shape=(4,), axis_names=("rows",), rank=0, device=None)
        hier = Mesh(shape=(2, 2), axis_names=("host", "chip"), rank=0, device=None)
        assert trow_axes(flat) == row_axes(make_mesh(4)) == "rows"
        assert trow_axes(hier) == (HOST, CHIP)

    def test_psum_rows_matches_flat(self, port):
        for k in range(P):
            np.testing.assert_allclose(get(port, "psum_hier", k), get(port, "psum_flat", k))
            np.testing.assert_allclose(get(port, "psum_hier", k), X_PSUM.sum(axis=0))

    def test_hier_tsqr_two_level(self, port):
        """Exact QR with a sign-fixed R; the R factors are gathered over the
        chip group (this host's ranks) and then the host group (this chip
        index across hosts), each (m, m) — not once over all P ranks."""
        out = get(port, "tsqr_hier")
        Q, R = out["Q"], out["R"]
        assert np.allclose(Q @ R, X_QR, atol=1e-12)
        assert np.allclose(Q.T @ Q, np.eye(5), atol=1e-12)
        assert np.all(np.diag(R) >= 0)
        np.testing.assert_allclose(R, get(port, "tsqr_flat")["R"], atol=1e-12)
        for p in range(P):
            calls = [c for c in get(port, "tsqr_hier", p)["calls"] if c[0] == "all_gather"]
            h, c = divmod(p, C)
            assert calls == [("all_gather", (C * h, C * h + 1), 25),
                             ("all_gather", (c, C + c), 25)], calls
            flat = [c for c in get(port, "tsqr_flat", p)["calls"] if c[0] == "all_gather"]
            assert flat == [("all_gather", tuple(range(P)), 25)]

    def test_halo_ring_dcn_boundary_only(self, port):
        """One exchange a block; of the ring's sends only the pair (1, 2),
        (2, 1) crosses the host boundary; the volume is that of the flat
        ring (2*halo a rank inside, halo at the ends)."""
        peers = [pair for p in range(P) for pair in get(port, "halo_hier", p)["peers"]]
        cross = sorted((a, b) for a, b in peers if a // C != b // C)
        assert cross == [(1, 2), (2, 1)], cross
        for p in range(P):
            h, f = get(port, "halo_hier", p), get(port, "halo_flat", p)
            assert h["exchanges"] == f["exchanges"] == 1
            assert h["halo_elems"] == f["halo_elems"] == (2 if 0 < p < P - 1 else 1) * h["halo"]


class TestHierParity:
    def test_powers_parity_vs_flat(self, port):
        from ca_lanczos_tpu.ops.spmv import DiaMatrix

        np.testing.assert_allclose(get(port, "pow_flat"), get(port, "pow_hier"), rtol=1e-6)
        mesh = make_mesh(P)
        A = DistDia.from_dia(DiaMatrix(data=jnp.asarray(LAP1K[0]), offsets=(-1, 0, 1)), mesh,
                             s_max=4)
        z = jnp.zeros(4, jnp.float32)
        V = np.asarray(dist_matrix_powers(A, A.shard_vector(R_POW, mesh), 4, z, z, mesh))
        np.testing.assert_allclose(get(port, "pow_hier"), V[: P * 256], rtol=1e-6, atol=1e-6)

    def test_ca_lanczos_natural(self, port):
        _ritz_parity(get(port, "ca_nat")["T"], LAP1K[0], R_NAT, 4, 8)

    def test_ca_lanczos_ilv(self, port):
        _ritz_parity(get(port, "ca_ilv")["T"], LAP4K[0], R_ILV, 4, 8)

    def test_restarted_planted_spectrum(self, port):
        out = get(port, "rst")
        assert out["converged"]
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], np.sort(TOP3)[::-1], rtol=1e-3)

    def test_irl_planted_spectrum(self, port):
        out = get(port, "irl")
        assert out["converged"]
        np.testing.assert_allclose(np.sort(out["eigs"])[::-1], np.sort(TOP2)[::-1], rtol=1e-3)
