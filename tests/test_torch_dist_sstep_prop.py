"""PyTorch port, ``parallel.dist_sstep`` and ``parallel.dist_prop`` on 4
gloo ranks against the JAX package on ``make_mesh(4)``: mirrors
tests/test_parallel.py ``TestDistSstep`` (T and Q to 1e-10) and
``TestPeriodicHalo`` (the periodic DIA product, here through
``dist_spmv_cols`` on a split multivector; the periodic ELL powers, and
the periodic PELL powers beside them; the split propagation to 1e-9),
with the JAX tests' inputs.  Each case runs JAX's own distributed
function on the same numpy inputs as well as the single-chip oracle.
The propagation also runs on a DistDia of the oscillator's circulant
planes (chip_smoke.py phase K(d)'s layout, ``data[d, i] = H[i, (i+k) mod
n]``), and in the adaptive form.

The port's ranks start once per module (``runtime.spawn`` of
``parallel.checks.run``) and run every case.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ca_lanczos_tpu.config import Basis
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers
from ca_lanczos_tpu.ops.spmv import DiaMatrix
from ca_lanczos_tpu.parallel import DistDia, DistEll, DistPell, make_mesh
from ca_lanczos_tpu.parallel import dist_ell_matrix_powers, dist_pell_matrix_powers
from ca_lanczos_tpu.parallel.dist_prop import dist_propagate_split, dist_spmv_cols
from ca_lanczos_tpu.parallel.dist_sstep import dist_sstep_lanczos
from ca_lanczos_tpu.solvers.propagators import propagate_split
from ca_lanczos_tpu.solvers.sstep import sstep_lanczos
from ca_lanczos_tpu.utils.matrices import gaussian_packet, harmonic_oscillator, laplacian_1d
from ca_lanczos_tpu_torch.parallel import checks
from ca_lanczos_tpu_torch.parallel.runtime import spawn

P = 4
SSTEP = [(2, 4), (4, 3)]
LAP = laplacian_1d(256)
R7 = np.random.default_rng(7).standard_normal(256)
_rng = np.random.default_rng(0)
PER_OFFS = (-2, -1, 0, 1, 2)
PER_DATA = _rng.standard_normal((5, 256))
X_PER2 = _rng.standard_normal((256, 2))
OSC512, _ = harmonic_oscillator(512)
X_OSC = np.random.default_rng(1).standard_normal(512)
OSC128, XG128 = harmonic_oscillator(128)
PSI0 = gaussian_packet(XG128).astype(np.complex128)
PROP = dict(dt=0.025, n_steps=5, krylov_dim=16)


def _ell(E):
    return ("ell", np.asarray(E.vals), np.asarray(E.cols))


def circulant_planes(E):
    """The (5, n) planes of a ring-banded ELL operator with
    ``data[d, i] = H[i, (i + k_d) mod n]``, k_d = -2..2."""
    vals, cols = np.asarray(E.vals), np.asarray(E.cols)
    n = vals.shape[0]
    k = np.mod(cols - np.arange(n)[:, None] + n // 2, n) - n // 2
    data = np.zeros((5, n))
    for j in range(vals.shape[1]):
        np.add.at(data, (k[:, j] + 2, np.arange(n)), vals[:, j])
    return data


CIRC128 = circulant_planes(OSC128)


def _specs():
    specs = [
        (f"sstep_{s}_{m}", "sstep", dict(data=np.asarray(LAP.data), offsets=tuple(LAP.offsets),
                                         r=R7, s=s, m=m)) for s, m in SSTEP
    ]
    specs += [
        ("cols_dia", "spmv_cols", dict(op=("dia", PER_DATA, PER_OFFS), x=X_PER2, s_max=2,
                                       periodic=True)),
        ("cols_ell", "spmv_cols", dict(op=_ell(OSC512), x=np.stack([X_OSC, -X_OSC], 1),
                                       periodic=True)),
        ("per_ell", "gen_powers", dict(op=_ell(OSC512), x=X_OSC, s=4, periodic=True)),
        ("per_pell", "gen_powers", dict(op=_ell(OSC512), x=X_OSC, s=4, periodic=True,
                                        dist_format="pell")),
        ("prop_ell", "propagate", dict(op=_ell(OSC128), psi0=PSI0, **PROP)),
        ("prop_dia", "propagate", dict(op=("dia", CIRC128, PER_OFFS), psi0=PSI0, **PROP)),
        ("prop_adaptive", "propagate", dict(op=_ell(OSC128), psi0=PSI0, adaptive=True,
                                            **PROP)),
    ]
    return specs


@pytest.fixture(scope="module")
def port():
    return spawn(checks.run, P, "cpu", _specs(), threads=1, timeout=600)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(P)


def get(port, cid, rank=0):
    out = port[rank][cid]
    if isinstance(out, dict) and "__error__" in out:
        pytest.fail(f"rank {rank}, case {cid}:\n{out['__error__']}")
    return out


class TestDistSstep:
    @pytest.mark.parametrize("s,m", SSTEP)
    def test_matches_single_chip(self, port, mesh, s, m):
        out = get(port, f"sstep_{s}_{m}")
        res_1 = sstep_lanczos(LAP, jnp.asarray(R7), s, m)
        res_j = dist_sstep_lanczos(LAP, R7, s, m, mesh)
        for ref in (res_1, res_j):
            np.testing.assert_allclose(out["T"], ref.T, rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(out["Q"], np.asarray(ref.Q)[:256], rtol=1e-10,
                                       atol=1e-10)

    def test_T_replicated(self, port):
        """Every rank assembles the same T from the same all-reduced dots."""
        for cid in (f"sstep_{s}_{m}" for s, m in SSTEP):
            T0 = get(port, cid)["T"]
            for rank in range(1, P):
                np.testing.assert_array_equal(get(port, cid, rank)["T"], T0)


class TestPeriodicHalo:
    def test_periodic_dia_spmv_cols(self, port, mesh):
        """Circulant-banded planes on the ring halo, two columns at once."""
        n = 256
        dense = np.zeros((n, n))
        for d, k in enumerate(PER_OFFS):
            dense[np.arange(n), (np.arange(n) + k) % n] = PER_DATA[d]
        y = get(port, "cols_dia")
        np.testing.assert_allclose(y, dense @ X_PER2, atol=1e-12)
        Ad = DistDia.from_dia(DiaMatrix(data=jnp.asarray(PER_DATA), offsets=PER_OFFS), mesh,
                              s_max=2, periodic=True)
        y_j = np.asarray(dist_spmv_cols(Ad, Ad.shard_vector(X_PER2, mesh), mesh))[:n]
        np.testing.assert_allclose(y, y_j, atol=1e-12)

    def test_periodic_ell_spmv_cols(self, port, mesh):
        X = np.stack([X_OSC, -X_OSC], 1)
        y = get(port, "cols_ell")
        np.testing.assert_allclose(y, np.asarray(OSC512.to_dense()) @ X, rtol=1e-12,
                                   atol=1e-9)
        Hd = DistEll.from_ell(OSC512, mesh, s_max=1, periodic=True)
        y_j = np.asarray(dist_spmv_cols(Hd, Hd.shard_vector(X, mesh), mesh))[:512]
        np.testing.assert_allclose(y, y_j, rtol=1e-12, atol=1e-9)

    @pytest.mark.parametrize("fmt", ["ell", "pell"])
    def test_periodic_powers(self, port, mesh, fmt):
        """The oscillator's mod-n wrap columns through the ring halo, on the
        ELL gather and on K4's window (its plain version here)."""
        out = get(port, f"per_{fmt}")
        assert out["type"] == ("DistPell" if fmt == "pell" else "DistEll")
        V_ref = np.asarray(matrix_powers(OSC512, jnp.asarray(X_OSC), 4, None, Basis.MONOMIAL))
        np.testing.assert_allclose(out["V"], V_ref, rtol=1e-11, atol=1e-9)
        cls, fn = ((DistPell, dist_pell_matrix_powers) if fmt == "pell"
                   else (DistEll, dist_ell_matrix_powers))
        Hd = cls.from_ell(OSC512, mesh, s_max=4, periodic=True)
        z = jnp.zeros(4)
        V_j = np.asarray(fn(Hd, Hd.shard_vector(X_OSC, mesh), 4, z, z, mesh))[:512]
        np.testing.assert_allclose(out["V"], V_j, rtol=1e-11, atol=1e-9)

    @pytest.mark.parametrize("cid", ["prop_ell", "prop_dia", "prop_adaptive"])
    def test_dist_propagation_matches_single_chip(self, port, mesh, cid):
        """The distributed split propagation of the reference Hamiltonian
        equals the single-chip split propagator and JAX's distributed one
        to 1e-9, on a DistEll and on a DistDia of its circulant planes."""
        adaptive = cid == "prop_adaptive"
        psi = get(port, cid)
        psi_1 = np.asarray(propagate_split(OSC128, PSI0, PROP["dt"], PROP["n_steps"],
                                           krylov_dim=PROP["krylov_dim"], adaptive=adaptive))
        Hd = (DistDia.from_dia(DiaMatrix(data=jnp.asarray(CIRC128), offsets=PER_OFFS), mesh,
                               s_max=1, periodic=True) if cid == "prop_dia"
              else DistEll.from_ell(OSC128, mesh, s_max=1, periodic=True))
        psi_j = dist_propagate_split(Hd, PSI0, PROP["dt"], PROP["n_steps"], mesh,
                                     krylov_dim=PROP["krylov_dim"], adaptive=adaptive)
        np.testing.assert_allclose(psi, psi_1, atol=1e-9)
        np.testing.assert_allclose(psi, psi_j, atol=1e-9)
        assert abs(np.linalg.norm(psi) / np.linalg.norm(PSI0) - 1.0) < 1e-10
