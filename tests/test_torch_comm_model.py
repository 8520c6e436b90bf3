"""PyTorch port, the communication model of ``parallel/`` counted through
its collectives wrapper (``parallel.comm``) on 4 gloo ranks; mirrors
tests/test_comm_model.py, whose volumes come from the JAX package's
lowered jaxprs on ``make_mesh(4)``:

* one halo exchange per s-step block, ``2*halo`` elements a rank inside
  the ring (``halo = s_max*w``), the same for every s <= s_max, equal to
  the JAX package's ppermute volume; linear in the bandwidth w;
* the interleaved engine exchanges its two (J, 128) edge blocks a block;
* a whole ``dist_ca_lanczos`` run: one exchange per block;
* the block orthogonalization's all-reduces and all-gathers are
  O((s+1)^2) each, independent of n.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ca_lanczos_tpu.parallel import make_mesh
from ca_lanczos_tpu.parallel.distributed import DistDia, dist_matrix_powers
from ca_lanczos_tpu.utils.matrices import laplacian_1d
from ca_lanczos_tpu_torch.parallel import checks
from ca_lanczos_tpu_torch.parallel.runtime import spawn
from tests.test_comm_model import collective_bytes

P = 4
N = P * 512


def _lap32(n):
    return np.asarray(laplacian_1d(n, dtype=jnp.float32).data), (-1, 0, 1)


def _band(w):
    rng = np.random.default_rng(0)
    offsets = tuple(range(-w, w + 1))
    return (rng.standard_normal((len(offsets), N)) * 0.1).astype(np.float32), offsets


LAP = _lap32(N)
SPECS = [(f"s{s}", "comm_powers", dict(data=LAP[0], offsets=LAP[1], s=s, s_max=8))
         for s in (2, 4, 8)]
SPECS += [(f"w{w}", "comm_powers", dict(data=_band(w)[0], offsets=_band(w)[1], s=4, s_max=4))
          for w in (1, 2, 4)]
SPECS += [(f"block{n}", "comm_block", dict(data=_lap32(n)[0], offsets=(-1, 0, 1), s=4))
          for n in (N, 2 * N)]
SPECS += [
    ("ilv", "comm_ilv_powers", dict(data=_lap32(P * 1024)[0], offsets=(-1, 0, 1), s=4)),
    ("ca", "comm_ca", dict(data=LAP[0], offsets=LAP[1], r=np.ones(N), s=4, steps=24)),
]


@pytest.fixture(scope="module")
def port():
    return spawn(checks.run, P, "cpu", SPECS, threads=1, timeout=300)


def get(port, cid, rank=0):
    out = port[rank][cid]
    if isinstance(out, dict) and "__error__" in out:
        pytest.fail(f"rank {rank}, case {cid}:\n{out['__error__']}")
    return out


def _jax_halo_bytes(data, offsets, s, s_max):
    from ca_lanczos_tpu.ops.spmv import DiaMatrix

    mesh = make_mesh(P)
    A = DistDia.from_dia(DiaMatrix(data=jnp.asarray(data), offsets=offsets), mesh, s_max=s_max)
    x = A.shard_vector(np.ones(N, np.float32), mesh)
    z = jnp.zeros(s, jnp.float32)
    total, calls = collective_bytes(lambda xx: dist_matrix_powers(A, xx, s, z, z, mesh), x)
    return total, len([c for c in calls if c[0] == "ppermute"])


class TestHaloVolume:
    @pytest.mark.parametrize("s", [2, 4, 8])
    def test_one_exchange_per_block_volume_independent_of_s(self, port, s):
        total, n_perm = _jax_halo_bytes(*LAP, s, 8)
        for p in range(P):
            out = get(port, f"s{s}", p)
            assert out["exchanges"] == 1
            inner = 0 < p < P - 1
            assert out["halo_elems"] == (2 if inner else 1) * out["halo"] == (
                2 if inner else 1) * 8
            if inner:  # JAX's ppermute volume is per device, edges included
                assert n_perm == 2 and out["halo_elems"] * 4 == total

    @pytest.mark.parametrize("w", [1, 2, 4])
    def test_volume_linear_in_bandwidth(self, port, w):
        total, _ = _jax_halo_bytes(*_band(w), 4, 4)
        out = get(port, f"w{w}", 1)
        assert out["halo_elems"] == 2 * 4 * w
        assert out["halo_elems"] * 4 == total


class TestIlvEdges:
    def test_two_edge_blocks_per_block(self, port):
        for p in range(P):
            out = get(port, "ilv", p)
            assert out["exchanges"] == 1
            assert out["halo_elems"] == (2 if 0 < p < P - 1 else 1) * 8 * 128


class TestBlockReductions:
    def test_block_orth_reductions_independent_of_n(self, port):
        a, b = get(port, f"block{N}", 1), get(port, f"block{2 * N}", 1)
        assert a["exchanges"] == b["exchanges"] == 1
        assert a["all_reduce"] > 0 and a["all_gather"] > 0
        assert [c[2] for c in a["calls"]] == [c[2] for c in b["calls"]]
        for c in a["calls"]:
            assert c[2] <= (4 + 1) ** 2 < a["n_local"], c

    def test_one_exchange_per_block_in_a_run(self, port):
        assert get(port, "ca", 1)["exchanges"] == 24 // 4
