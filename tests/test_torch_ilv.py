"""PyTorch port, ops/cuda_ilv.py: the plain version of K3
(``dia_powers_ilv_ref``) against the TPU kernel ``dia_powers_ilv`` in
Pallas interpret mode (as tests/test_pallas_ilv.py runs it, n = 32768,
Tq = 1024), the interleave codec, the halo guard, and ``IlvDiaMatrix``
against the JAX carrier.

Tolerances: f32 rtol 1e-5 and f64 rtol 1e-12, relative to max|ref| per
step (sums run in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ca_lanczos_tpu.ops import pallas_ilv as jilv
from ca_lanczos_tpu.ops.spmv import DiaMatrix as JDia
from ca_lanczos_tpu_torch.ops import cuda_ilv
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
N, TQ = 8 * 2048 * 2, 1024  # nq = 4096, 4 tiles of the TPU kernel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _op(n, dtype, nd=9, seed=0):
    rng = np.random.default_rng(seed)
    half = nd // 2
    data = (rng.standard_normal((nd, n)) / nd).astype(dtype)
    return JDia(data=jnp.asarray(data), offsets=tuple(range(-half, half + 1)))


def _close_per_step(got, want, rtol):
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    for j in range(want.shape[0]):
        np.testing.assert_allclose(got[j], want[j], rtol=0,
                                   atol=rtol * np.max(np.abs(want[j])), err_msg=f"step {j}")


@pytest.mark.parametrize("s,with_coefs,dtype", [(3, True, np.float32),
                                                (4, False, np.float64)])
def test_k3_plain_matches_pallas_interpret(s, with_coefs, dtype):
    Aj = _op(N, dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(N).astype(dtype)
    c = rng.standard_normal((s, 2)) * 0.1 if with_coefs else np.zeros((s, 2))
    Vj, lj = jilv.dia_powers_ilv(
        jnp.asarray(jilv.ilv_data_tiled(Aj, TQ)), jnp.asarray(jilv.ilv_encode(x)),
        jnp.asarray(c, dtype), Aj.offsets, s, TQ, N, interpret=True, with_coefs=with_coefs)
    At = operator_from_numpy(jilv.IlvDiaMatrix.from_dia(Aj, tq=TQ, keep_dia=True), device="cpu")
    V, last = cuda_ilv.dia_powers_ilv(At.data_il, torch.as_tensor(jilv.ilv_encode(x)),
                                      c if with_coefs else None, At.offsets, s)
    _close_per_step(V.numpy(), np.asarray(Vj), RTOL[dtype])
    _close_per_step(last.numpy(), np.asarray(lj), RTOL[dtype])


def test_codec_round_trips_and_matches_jax():
    x = np.arange(8 * 4096, dtype=np.float32)
    enc = cuda_ilv.ilv_encode(x)
    np.testing.assert_array_equal(enc, jilv.ilv_encode(x))
    np.testing.assert_array_equal(cuda_ilv.ilv_decode(enc), x)
    np.testing.assert_array_equal(cuda_ilv.ilv_encode(cuda_ilv.ilv_decode(x)), x)
    xt = torch.as_tensor(x)
    torch.testing.assert_close(cuda_ilv.ilv_encode(xt), torch.as_tensor(enc))
    torch.testing.assert_close(cuda_ilv.ilv_decode(cuda_ilv.ilv_encode(xt)), xt)
    # blocks encode column by column
    X = np.stack([x, 2 * x], axis=1)
    np.testing.assert_array_equal(cuda_ilv.ilv_encode(X)[:, 1], jilv.ilv_encode(2 * x))
    torch.testing.assert_close(cuda_ilv.ilv_decode(cuda_ilv.ilv_encode(torch.as_tensor(X))),
                               torch.as_tensor(X))


def test_halo_overflow_raises_like_jax():
    A = operator_from_numpy(_op(N, np.float32), device="cpu")
    Aw = DiaMatrix(data=torch.zeros((3, N)), offsets=(-700, 0, 700))
    Ail = cuda_ilv.IlvDiaMatrix.from_dia(Aw)
    assert Ail.s_max == cuda_ilv.WQ // 88
    x = torch.zeros(N)
    with pytest.raises(ValueError, match="ilv halo overflow"):
        cuda_ilv.dia_powers_ilv(Ail.data_il, x, None, Ail.offsets, Ail.s_max + 1)
    assert cuda_ilv.IlvDiaMatrix.from_dia(A).s_max == jilv.IlvDiaMatrix.from_dia(
        _op(N, np.float32), tq=TQ).s_max
    with pytest.raises(ValueError, match="bandwidth"):
        cuda_ilv.IlvDiaMatrix.from_dia(DiaMatrix(data=torch.zeros((1, N)), offsets=(9000,)))


def test_carrier_matvec_and_powers_match_jax():
    Aj = _op(N, np.float32, seed=2)
    Ij = jilv.IlvDiaMatrix.from_dia(Aj, tq=TQ, keep_dia=True)
    It = operator_from_numpy(Ij, device="cpu")
    assert It.shape == Ij.shape and It.nnz == Ij.nnz
    rng = np.random.default_rng(3)
    x = jilv.ilv_encode(rng.standard_normal(N).astype(np.float32))
    xt = torch.as_tensor(x)
    _close_per_step(It.matvec(xt).numpy(), np.asarray(Ij.matvec(jnp.asarray(x))), 1e-5)
    X = rng.standard_normal((N, 3)).astype(np.float32)
    np.testing.assert_allclose(It.matvec(torch.as_tensor(X)).numpy(),
                               np.asarray(Ij.matvec(jnp.asarray(X))), rtol=1e-5, atol=1e-6)
    diag, sub = np.array([0.1, -0.2, 0.05]), np.array([0.0, 0.01, 0.02])
    Vt = It.powers(xt, 3, diag, sub).numpy()
    Vj = np.asarray(Ij.powers(jnp.asarray(x), 3, diag, sub))
    _close_per_step(Vt.T, Vj.T, 1e-5)


def test_chained_single_steps_equal_one_fused_call():
    # the wrapper's fallback when the s-step window does not fit: s
    # single steps chained through x_prev give the same block
    A = cuda_ilv.IlvDiaMatrix.from_dia(
        operator_from_numpy(_op(N, np.float64, seed=4), device="cpu"))
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(N))
    c = np.array([[0.1, 0.0], [0.2, 0.03], [-0.1, 0.02]])
    V, last = cuda_ilv.dia_powers_ilv_ref(A.data_il, x, c, A.offsets, 3)
    prev, cur = None, x
    for j in range(3):
        Vj, _ = cuda_ilv.dia_powers_ilv_ref(A.data_il, cur, c[j:j + 1], A.offsets, 1, prev)
        torch.testing.assert_close(Vj[0], V[j], rtol=1e-12, atol=1e-14)
        prev, cur = cur, Vj[0]
    torch.testing.assert_close(cur, last, rtol=1e-12, atol=1e-14)


def test_pick_tq_fits_shared_memory():
    for nd, mc, s, dt in [(3, 1, 8, torch.float32), (9, 1, 8, torch.float32),
                          (9, 1, 8, torch.float64)]:
        tq = cuda_ilv.pick_tq(nd, mc, s, dt)
        item = 4 if dt == torch.float32 else 8
        assert tq >= 64 and (nd + 2) * 8 * (tq + 2 * s * mc) * item <= cuda_ilv.SMEM_TARGET
    # a window that never fits at s steps, but does one step at a time
    assert cuda_ilv.pick_tq(9, 128, 8, torch.float32) == 0
    assert cuda_ilv.pick_tq(9, 128, 1, torch.float32) > 0


def test_block_product_needs_the_normal_layout_planes():
    A = cuda_ilv.IlvDiaMatrix.from_dia(
        operator_from_numpy(_op(N, np.float32, seed=6), device="cpu"), keep_dia=False)
    with pytest.raises(ValueError, match="keep_dia=True"):
        A.matvec(torch.zeros((N, 2)))


def _pick_tq_before(nd, mc, s, item):
    """The tile rule K3 had before its register kernel (one tile per block,
    the planes and both vectors staged): the cases it fitted must still fit."""
    hq = s * mc
    for budget in (cuda_ilv.SMEM_TARGET, cuda_ilv.SMEM_MAX):
        for tq in (1024, 512, 256, 128, 64, 32):
            if (s == 1 or hq <= tq) and (nd + 2) * 8 * (tq + 2 * hq) * item <= budget:
                return tq
    return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ilv_plan_fits_and_keeps_the_halo_inside_the_tile(dtype):
    item = torch.empty((), dtype=dtype).element_size()
    for nd in (1, 2, 3, 4, 5, 8, 9, 12, 16, 17, 24, 33, 64, 128):
        for mc in (0, 1, 2, 3, 16, 64, 128, 1024):
            for s in (1, 2, 4, 8):
                plan = cuda_ilv.ilv_plan(nd, mc, s, dtype)
                if _pick_tq_before(nd, mc, s, item):
                    assert plan is not None, (nd, mc, s)
                if plan is None:
                    assert cuda_ilv.pick_tq(nd, mc, s, dtype) == 0
                    continue
                assert (plan.hq, plan.g) == (s * mc, mc)
                assert plan.lq == plan.tq + 2 * plan.hq and plan.tq >= 1
                if s > 1:
                    assert plan.hq <= plan.tq
                assert plan.smem == cuda_ilv.ilv_smem(nd, plan.lq, mc, item, plan.reg)
                assert plan.smem <= cuda_ilv.SMEM_MAX
                if plan.reg:
                    ndm = min(k for k in cuda_ilv.REG_CPT[item] if nd <= k)
                    assert plan.lq == cuda_ilv.ROW_LANES * cuda_ilv.REG_CPT[item][ndm]
                else:
                    assert plan.tq in (1024, 512, 256, 128, 64, 32)
    # the main paths' shapes (3 and 9 diagonals, s = 8) take the register
    # kernel; a halo wider than any tile still chains single steps
    for nd in (3, 9):
        assert cuda_ilv.ilv_plan(nd, 1, 8, dtype).reg
    assert cuda_ilv.ilv_plan(17, 1, 8, dtype).reg is False
    assert cuda_ilv.ilv_plan(5, 113, 4, dtype) is None
    assert cuda_ilv.ilv_plan(5, 113, 1, dtype) is not None
