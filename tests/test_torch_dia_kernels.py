"""PyTorch port, ops/cuda_spmv.py: the plain versions of K1
(``dia_powers_fused_ref``) and K2 (``dia_power_step_ref``) against the
TPU kernels run in Pallas interpret mode on CPU (as tests/test_pallas.py
runs them), and the wrappers' CPU path, operand checks and K1 planner.

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


def _fused_tile_before(nd, wmax, s, item):
    """The tile rule K1 had before its register kernel: the shapes it
    fitted must still fit."""
    if nd > cuda_spmv.MAX_DIAGS or s > cuda_spmv.MAX_STEPS:
        return 0
    halo = s * max(wmax, 1)
    for budget in (cuda_spmv.SMEM_TARGET, cuda_spmv.SMEM_MAX):
        for t in (4096, 2048, 1024, 512, 256):
            if halo <= t and (nd + 2) * (t + 2 * halo) * item <= budget:
                return t
    return 0


def _check_plan(plan, nd, wmax, s, item):
    if _fused_tile_before(nd, wmax, s, item):
        assert plan.variant != "steps", (nd, wmax, s)
    if plan.variant == "steps":
        assert plan == cuda_spmv.STEPS_PLAN
        return
    window = plan.tile + 2 * plan.halo
    assert plan.halo >= s * wmax and plan.tile >= 1
    if s > 1:
        assert plan.halo <= plan.tile
    assert plan.smem == cuda_spmv.k1_smem(nd, window, plan.bw, item) <= cuda_spmv.SMEM_MAX
    if plan.variant in ("reg", "band"):
        # whole vectors for every thread, the halo and tile whole vectors too;
        # the narrowest band capacity that holds wmax, 16 for "band"
        assert (plan.rows, plan.vecs) == cuda_spmv.K1_REG[item][plan.bw]
        assert window == plan.rows * cuda_spmv.K1_THREADS * plan.vecs
        assert plan.halo % plan.rows == 0 and plan.tile % plan.rows == 0
        assert plan.bw == min(b for b in cuda_spmv.K1_REG[item] if b >= wmax)
        assert (plan.variant == "band") == (plan.bw == 16)
    else:
        assert (plan.vecs, plan.rows, plan.bw) == (0, 0, 0) and plan.halo == s * max(wmax, 1)


# (nd, max |offset|, s, variant per dtype (f32, f64)): bench.py's shape and
# main path A's, a band too wide for the register kernels, one too wide for
# any s-step window, 16 and 17 diagonals inside +-8 (the narrow register
# kernel's widest band) and 17 inside +-10 (the wide-band kernel), phase
# H's 31 diagonals inside +-15 at s = 8 and at s = 16 (whose halo leaves
# the f64 wide-band window, pairs of rows, no tile), a single diagonal, and
# a halo that leaves every register window no tile.
K1_PLAN_CASES = {
    "bench": (9, 4, 8, ("reg", "reg")),
    "path_a": (3, 1, 8, ("reg", "reg")),
    "wide_band": (5, 100, 4, ("smem", "smem")),
    "too_wide": (5, 2000, 8, ("steps", "steps")),
    "nd16": (16, 8, 8, ("reg", "reg")),
    "nd17_in_band": (17, 8, 8, ("reg", "reg")),
    "nd17_wider": (17, 10, 8, ("band", "band")),
    "bsr_dia_s8": (31, 15, 8, ("band", "band")),
    "bsr_dia_s16": (31, 15, 16, ("band", "smem")),
    "diagonal": (1, 0, 8, ("reg", "reg")),
    "many_steps": (9, 8, 64, ("smem", "smem")),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(K1_PLAN_CASES))
def test_k1_plan(case, dtype):
    nd, wmax, s, variants = K1_PLAN_CASES[case]
    item = torch.empty((), dtype=dtype).element_size()
    plan = cuda_spmv.k1_plan(nd, wmax, s, dtype)
    assert plan.variant == variants[item == 8]
    _check_plan(plan, nd, wmax, s, item)
    assert cuda_spmv.fused_tile(nd, wmax, s, dtype) == plan.tile
    # a repeated offset takes the same plan (the register kernels sum its
    # planes into one band slot)
    if nd > 1:
        offsets = [wmax, wmax] + [o % (2 * wmax + 1) - wmax for o in range(nd - 2)]
        assert cuda_spmv.k1_plan_for(offsets, s, dtype) == plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_plan_sweep_fits(dtype):
    item = torch.empty((), dtype=dtype).element_size()
    for nd in (1, 2, 3, 5, 9, 16, 17, 33, 128, 129):
        for wmax in (0, 1, 2, 3, 4, 5, 8, 9, 64, 500, 4096):
            for s in (1, 2, 4, 8, 16, 64, 65):
                plan = cuda_spmv.k1_plan(nd, wmax, s, dtype)
                _check_plan(plan, nd, wmax, s, item)
                if nd <= min(2 * wmax + 1, 17) and wmax <= 8 and s <= 8:
                    assert plan.variant == "reg", (nd, wmax, s)


def _tiled_powers(data, x, coefs, offsets, s, plan):
    """K1 as its tiles compute it: each tile runs the s steps on its window
    alone (zero beyond the window and outside [0, n)) and keeps its owned
    rows; the plan's halo must make that equal to the whole recurrence."""
    nd, n = data.shape
    window = plan.tile + 2 * plan.halo
    V = torch.empty((s, n), dtype=x.dtype)
    for t0 in range(0, n, plan.tile):
        lo, hi = t0 - plan.halo, t0 - plan.halo + window
        a, b = max(lo, 0), min(hi, n)
        dw = torch.zeros((nd, window), dtype=data.dtype)
        xw = torch.zeros(window, dtype=x.dtype)
        dw[:, a - lo:b - lo] = data[:, a:b]
        xw[a - lo:b - lo] = x[a:b]
        Vw, _ = cuda_spmv.dia_powers_fused_ref(dw, xw, coefs, offsets, s)
        keep = min(plan.tile, n - t0)
        V[:, t0:t0 + keep] = Vw[:, plan.halo:plan.halo + keep]
    return V


# (offsets, n, s, Newton coefficients, variant): ragged and whole last
# tiles, n below one tile, s = 1 and 8, asymmetric offsets, the widest
# narrow register band; the wide-band kernel's f64 windows (pairs of rows)
# at phase H's 31 diagonals and with a repeated offset; the shared-memory
# kernel's window.
K1_TILE_CASES = {
    "tri_ragged": ((-1, 0, 1), 3 * 2040 + 37, 8, True, "reg"),
    "nine_whole": (tuple(range(-4, 5)), 4 * 960, 8, True, "reg"),
    "below_tile": (tuple(range(-4, 5)), 301, 8, False, "reg"),
    "one_step": ((-2, 0, 3), 2500, 1, True, "reg"),
    "asym": ((-3, 0, 2), 5003, 8, True, "reg"),
    "band16": (tuple(range(-8, 8)), 2 * 896 + 5, 8, True, "reg"),
    "wide31": (tuple(range(-15, 16)), 3 * 392 + 11, 4, True, "band"),
    "wide_repeated": ((-12, -1, 0, 0, 5, 5, 12), 2 * 352 + 3, 8, True, "band"),
    "smem": ((-30, -1, 0, 1, 30), 9000, 4, True, "smem"),
}


@pytest.mark.parametrize("case", sorted(K1_TILE_CASES))
def test_k1_tiles_recompose_the_recurrence(case):
    offsets, n, s, newton, variant = K1_TILE_CASES[case]
    rng = np.random.default_rng(12)
    data = torch.as_tensor(rng.standard_normal((len(offsets), n)) * 0.3)
    x = torch.as_tensor(rng.standard_normal(n))
    c = _coefs(s, newton, seed=13)
    plan = cuda_spmv.k1_plan_for(offsets, s, torch.float64)
    assert plan.variant == variant
    Vr, _ = cuda_spmv.dia_powers_fused_ref(data, x, c, offsets, s)
    _close_per_step(_tiled_powers(data, x, c, offsets, s, plan).numpy(), Vr.numpy(), 1e-12)
