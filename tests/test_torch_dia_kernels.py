"""PyTorch port, ops/cuda_spmv.py: the plain versions of K1
(``dia_powers_fused_ref``) and K2 (``dia_power_step_ref``) against the
TPU kernels run in Pallas interpret mode on CPU (as tests/test_pallas.py
runs them), and the wrappers' CPU path, operand checks and tile picker.

Tolerances: f64 rtol 1e-12, f32 rtol 1e-5 relative to max|ref| per step
(the interpret kernel sums the diagonals as a balanced tree, the port in
diagonal order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ca_lanczos_tpu.ops.matrix_powers import _newton_scan
from ca_lanczos_tpu.ops.pallas_spmv import _dia_power_step, _dia_powers_fused, dia_flat_padded
from ca_lanczos_tpu.ops.spmv import DiaMatrix as JDia
from ca_lanczos_tpu_torch.config import Basis
from ca_lanczos_tpu_torch.ops import cuda_spmv
from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
OFFSETS = {"tri": (-1, 0, 1), "nine": tuple(range(-4, 5)), "asym": (-3, 0, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _banded(n, offsets, dtype, seed=0):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((len(offsets), n)) * 0.3).astype(dtype)
    return JDia(data=jnp.asarray(data), offsets=tuple(offsets))


def _coefs(s, newton, seed=1):
    if not newton:
        return None
    rng = np.random.default_rng(seed)
    c = np.zeros((s, 2))
    c[:, 0] = rng.uniform(-0.5, 0.5, s)
    c[1:, 1] = rng.uniform(0.0, 0.05, s - 1)
    return c


def _close_per_step(got, want, rtol):
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    for j in range(want.shape[0]):
        scale = np.max(np.abs(want[j]))
        np.testing.assert_allclose(got[j], want[j], rtol=0, atol=rtol * scale,
                                   err_msg=f"step {j}")


# Each case is one (offsets, s, coefficients, dtype) combination; together
# they cover every offset set at s=1 and s=4, monomial and Newton, f32/f64.
K1_CASES = [
    ("tri", 1, True, np.float64), ("tri", 4, False, np.float32),
    ("tri", 4, True, np.float64), ("nine", 1, False, np.float64),
    ("nine", 4, True, np.float32), ("nine", 4, True, np.float64),
    ("asym", 1, True, np.float32), ("asym", 4, False, np.float64),
]


@pytest.mark.parametrize("offs,s,newton,dtype", K1_CASES)
def test_k1_plain_matches_pallas_interpret(offs, s, newton, dtype):
    n, tile = 4096, 2048
    offsets = OFFSETS[offs]
    Aj = _banded(n, offsets, dtype)
    x = np.random.default_rng(2).standard_normal(n).astype(dtype)
    c = _coefs(s, newton)
    W = ((s * max(abs(o) for o in offsets) + 1023) // 1024) * 1024
    cj = jnp.asarray(np.zeros((s, 2)) if c is None else c, dtype)
    Vj, lj = _dia_powers_fused(dia_flat_padded(Aj, W), jnp.asarray(x), cj, offsets, s,
                               tile=tile, interpret=True, with_coefs=c is not None)
    At = operator_from_numpy(Aj, device="cpu")
    V, last = cuda_spmv.dia_powers_fused(At.data, torch.as_tensor(x), c, offsets, s)
    assert V.dtype == At.dtype and V.shape == (s, n)
    _close_per_step(V.numpy(), np.asarray(Vj), RTOL[dtype])
    _close_per_step(last.numpy(), np.asarray(lj), RTOL[dtype])


@pytest.mark.parametrize("offs,dtype", [("tri", np.float64), ("nine", np.float32),
                                        ("asym", np.float64)])
def test_k2_plain_matches_pallas_interpret(offs, dtype):
    n = 2048
    offsets = OFFSETS[offs]
    Aj = _banded(n, offsets, dtype, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n).astype(dtype)
    vp = rng.standard_normal(n).astype(dtype)
    c = np.array([0.3, 0.02])
    yj = _dia_power_step(Aj.data, jnp.asarray(x), jnp.asarray(vp), jnp.asarray(c, dtype),
                         offsets, tile=1024, interpret=True)
    At = operator_from_numpy(Aj, device="cpu")
    y = cuda_spmv.dia_power_step(At.data, torch.as_tensor(x), torch.as_tensor(vp), c, offsets)
    _close_per_step(y.numpy(), np.asarray(yj), RTOL[dtype])
    # no coefficients: the plain DIA product
    y0 = cuda_spmv.dia_power_step(At.data, torch.as_tensor(x), None, None, offsets)
    _close_per_step(y0.numpy(), np.asarray(Aj.matvec(jnp.asarray(x))), RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_unaligned_n_matches_xla_newton_scan(dtype):
    # n = 1000 has no 1024-aligned tile: the TPU package ran its XLA scan.
    n, s = 1000, 4
    offsets = OFFSETS["asym"]
    Aj = _banded(n, offsets, dtype, seed=5)
    x = np.random.default_rng(6).standard_normal(n).astype(dtype)
    c = _coefs(s, True, seed=7)
    Vj = np.asarray(_newton_scan(Aj, jnp.asarray(x), s, jnp.asarray(c[:, 0], dtype),
                                 jnp.asarray(c[:, 1], dtype)))
    At = operator_from_numpy(Aj, device="cpu")
    V = cuda_spmv.matrix_powers_dia_fused(At, torch.as_tensor(x), s, c[:, 0], c[:, 1])
    _close_per_step(V.numpy().T, Vj.T, RTOL[dtype])
    # the K2-chain fallback computes the same block
    V2 = cuda_spmv.matrix_powers_dia_steps(At, torch.as_tensor(x), s, c[:, 0], c[:, 1])
    _close_per_step(V2.numpy().T, Vj.T, RTOL[dtype])


@pytest.mark.parametrize("basis", [Basis.MONOMIAL, Basis.NEWTON])
def test_matrix_powers_dispatcher_matches_jax(basis):
    from ca_lanczos_tpu.config import Basis as JBasis
    from ca_lanczos_tpu.ops.matrix_powers import matrix_powers as jmatrix_powers

    n, s = 3000, 5
    Aj = _banded(n, OFFSETS["nine"], np.float64, seed=8)
    x = np.random.default_rng(9).standard_normal(n)
    B = np.zeros((s + 1, s))
    B[np.arange(s), np.arange(s)] = np.linspace(-0.4, 0.4, s)
    B[np.arange(1, s + 1), np.arange(s)] = 1.0
    B[0, 1] = -0.01
    Vj = np.asarray(jmatrix_powers(Aj, jnp.asarray(x), s, B, JBasis(basis.value)))
    V = matrix_powers(operator_from_numpy(Aj, device="cpu"), torch.as_tensor(x), s, B, basis)
    _close_per_step(V.numpy().T, Vj.T, 1e-12)


def test_complex_shifts_take_the_plain_recurrence():
    n, s = 512, 2
    At = operator_from_numpy(_banded(n, OFFSETS["tri"], np.float64), device="cpu")
    B = np.zeros((s + 1, s), complex)
    B[0, 0], B[1, 1] = 0.1 + 0.2j, 0.1 - 0.2j
    B[1, 0] = B[2, 1] = 1.0
    x = torch.ones(n, dtype=torch.float64)
    V = matrix_powers(At, x, s, B, Basis.NEWTON)
    assert V.is_complex() and V.shape == (n, s + 1)


def test_wrappers_reject_bad_operands():
    data = torch.zeros((3, 64))
    x = torch.zeros(64)
    with pytest.raises(TypeError):
        cuda_spmv.dia_power_step(data, x.to(torch.complex64), None, None, (-1, 0, 1))
    with pytest.raises(TypeError):
        cuda_spmv.dia_power_step(data.int(), x.int(), None, None, (-1, 0, 1))
    with pytest.raises(TypeError):
        cuda_spmv.dia_powers_fused(data, x.double(), None, (-1, 0, 1), 2)
    with pytest.raises(ValueError):
        cuda_spmv.dia_powers_fused(torch.zeros((64, 3)).T, x, None, (-1, 0, 1), 2)
    with pytest.raises(ValueError):
        cuda_spmv.dia_powers_fused(data, x, None, (-1, 0, 1), cuda_spmv.MAX_STEPS + 1)
    with pytest.raises(TypeError):
        cuda_spmv.dia_powers_fused(data, x, np.ones((2, 2), complex), (-1, 0, 1), 2)


def test_fused_tile_budget_and_fallback():
    # tile plus halo of nd+2 buffers fits the preferred shared-memory budget
    for nd, w, s, dt in [(3, 1, 8, torch.float32), (9, 4, 8, torch.float32),
                         (9, 4, 8, torch.float64)]:
        t = cuda_spmv.fused_tile(nd, w, s, dt)
        item = 4 if dt == torch.float32 else 8
        assert t >= 256 and (nd + 2) * (t + 2 * s * w) * item <= cuda_spmv.SMEM_TARGET
    # a halo wider than any tile: 0 (the dispatcher then runs K2 steps)
    assert cuda_spmv.fused_tile(5, 2000, 8, torch.float32) == 0
    assert cuda_spmv.fused_tile(cuda_spmv.MAX_DIAGS + 1, 1, 2, torch.float32) == 0
