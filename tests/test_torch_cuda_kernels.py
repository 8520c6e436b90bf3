"""PyTorch port: the CUDA kernels K1-K5 against their plain versions on
the card, including the fallbacks (K1 -> K2 steps, K3 -> chained single
steps) and the three PELL encodings (K4 unit, K5 grouped and grouped4).
Needs a CUDA device and nvcc; skips elsewhere.  This file imports no JAX,
so on a machine without it run

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 1e-5 and f64 1e-12 relative to max|plain| per step (the
sums run in another order)."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ca_lanczos_tpu_torch.ops import cuda_ilv, cuda_pell, cuda_spmv, pell
from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, spmv

pytestmark = pytest.mark.requires_cuda
BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, ref):
    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(((got - ref).abs().amax(1) / ref.abs().amax(1)).max())


def _operands(n, offsets, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n)) * 0.3
    x = rng.standard_normal(n)
    return (torch.as_tensor(data, dtype=dtype, device=device),
            torch.as_tensor(x, dtype=dtype, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offsets", [(-1, 0, 1), tuple(range(-4, 5)), (-3, 0, 2)])
def test_k1_k2_k3_match_plain(cuda, dtype, offsets):
    n, s = 100_003 * 8, 6  # ragged against every tile
    D, X = _operands(n, offsets, dtype, cuda)
    c = np.stack([np.linspace(-0.3, 0.3, s), np.r_[0.0, np.full(s - 1, 0.01)]], 1)
    before = dict(cuda_spmv.LAUNCHES)
    V, last = cuda_spmv.dia_powers_fused(D, X, c, offsets, s)
    Vr, lr = cuda_spmv.dia_powers_fused_ref(D, X, c, offsets, s)
    assert _rel(V, Vr) <= BOUND[dtype] and _rel(last, lr) <= BOUND[dtype]
    y = cuda_spmv.dia_power_step(D, X, X.flip(0).contiguous(), c[1], offsets)
    yr = cuda_spmv.dia_power_step_ref(D, X, X.flip(0), c[1], offsets)
    assert _rel(y, yr) <= BOUND[dtype]
    assert cuda_spmv.LAUNCHES["dia_powers_fused"] == before["dia_powers_fused"] + 1
    assert cuda_spmv.LAUNCHES["dia_power_step"] == before["dia_power_step"] + 1
    D_il = cuda_ilv.IlvDiaMatrix.from_dia(DiaMatrix(data=D, offsets=offsets)).data_il
    X_il = cuda_ilv.ilv_encode(X).contiguous()
    V3, l3 = cuda_ilv.dia_powers_ilv(D_il, X_il, c, offsets, s)
    V3r, l3r = cuda_ilv.dia_powers_ilv_ref(D_il, X_il, c, offsets, s)
    assert _rel(V3, V3r) <= BOUND[dtype] and _rel(l3, l3r) <= BOUND[dtype]
    # monomial (no coefficients)
    V0, _ = cuda_spmv.dia_powers_fused(D, X, None, offsets, 3)
    assert _rel(V0, cuda_spmv.dia_powers_fused_ref(D, X, None, offsets, 3)[0]) <= BOUND[dtype]
    torch.cuda.synchronize()


def test_fallbacks_match_plain(cuda):
    # a band too wide for the s-step shared-memory windows
    n, s, offsets = 1 << 16, 4, (-900, -1, 0, 1, 900)
    D, X = _operands(n, offsets, torch.float64, cuda, seed=1)
    assert cuda_spmv.fused_tile(len(offsets), 900, s, torch.float64) == 0
    A = DiaMatrix(data=D, offsets=offsets)
    c = np.array([[0.1, 0.0], [0.2, 0.01], [-0.1, 0.02], [0.0, 0.01]])
    got = cuda_spmv.matrix_powers_dia_fused(A, X, s, c[:, 0], c[:, 1])
    Vr, _ = cuda_spmv.dia_powers_fused_ref(D, X, c, offsets, s)
    assert _rel(got[:, 1:].T.contiguous(), Vr) <= 1e-12
    mc = cuda_ilv.max_carry(offsets)
    assert cuda_ilv.pick_tq(len(offsets), mc, s, torch.float64) == 0
    D_il = cuda_ilv.IlvDiaMatrix.from_dia(A).data_il
    X_il = cuda_ilv.ilv_encode(X).contiguous()
    V3, l3 = cuda_ilv.dia_powers_ilv(D_il, X_il, c, offsets, s)
    V3r, l3r = cuda_ilv.dia_powers_ilv_ref(D_il, X_il, c, offsets, s)
    assert _rel(V3, V3r) <= 1e-12 and _rel(l3, l3r) <= 1e-12


def test_wrappers_refuse_mixed_devices(cuda):
    D, X = _operands(1024, (-1, 0, 1), torch.float32, cuda)
    with pytest.raises(ValueError):
        cuda_spmv.dia_power_step(D, X.cpu(), None, None, (-1, 0, 1))
    with pytest.raises(ValueError):
        cuda_spmv.dia_powers_fused(D, X[::2], None, (-1, 0, 1), 2)


def test_spmv_of_a_dia_vector_is_one_k2_launch(cuda):
    D, X = _operands(4099, (-2, 0, 3), torch.float32, cuda, seed=2)
    A = DiaMatrix(data=D, offsets=(-2, 0, 3))
    before = cuda_spmv.LAUNCHES["dia_power_step"]
    y = spmv(A, X)
    assert cuda_spmv.LAUNCHES["dia_power_step"] == before + 1
    assert _rel(y, A.matvec(X)) <= BOUND[torch.float32]


def _pell_matrix(n, seed=3):
    """Random columns in a +-300 band, plus a periodic wrap that needs a
    second x-span window at sw=1024, n not a multiple of the tile."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-300, 301, rows.shape), 0, n - 1)
    a = sp.csr_matrix((rng.standard_normal(rows.shape), (rows, cols)), (n, n)).tolil()
    a[0, n - 1] = a[n - 1, 0] = 0.5
    a = sp.csr_matrix(a)
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("enc", ["unit", "grouped", "grouped4"])
def test_k4_k5_match_plain(cuda, enc, dtype):
    n = 40_000 + 37
    a = _pell_matrix(n)
    A = pell.PellMatrix.from_scipy(a.astype(np.float64 if dtype == torch.float64
                                            else np.float32),
                                   sw=4096, encoding=enc, device=cuda)
    assert A.enc == enc and A.n_win >= 2 and A.dtype == dtype
    rng = np.random.default_rng(5)
    x = torch.zeros(A.n_x, dtype=dtype, device=cuda)
    vp = torch.zeros_like(x)
    x[:n] = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    vp[:n] = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    key = "pell_step_unit" if enc == "unit" else "pell_step_grouped"
    before = cuda_pell.LAUNCHES[key]
    y = cuda_pell.pell_step(A, x, vp, 0.7, -0.3)
    assert cuda_pell.LAUNCHES[key] == before + 1
    yr = pell.pell_step_ref(A, x, vp, 0.7, -0.3)
    assert _rel(y, yr) <= BOUND[dtype]
    y0 = cuda_pell.pell_step(A, x)  # no v_prev, no shifts: the plain product
    want = torch.as_tensor(a @ x[:n].cpu().numpy().astype(np.float64), device=cuda)
    assert _rel(y0[:n].double(), want) <= BOUND[dtype]
    s = 4
    diag, sub = np.linspace(-0.2, 0.2, s), np.r_[0.0, np.full(s - 1, 0.05)]
    V = pell.matrix_powers_pell(A, x[:n], s, diag, sub)
    assert cuda_pell.LAUNCHES[key] == before + 2 + s
    Vr = pell.matrix_powers_pell(A.to("cpu"), x[:n].cpu(), s, diag, sub)
    assert _rel(V.T.contiguous().cpu(), Vr.T.contiguous()) <= BOUND[dtype]
    torch.cuda.synchronize()


def test_spmv_of_a_pell_vector_is_one_launch(cuda):
    a = _pell_matrix(9000, seed=4).astype(np.float32)
    A = pell.PellMatrix.from_scipy(a, encoding="grouped", device=cuda)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(9000), dtype=torch.float32,
                        device=cuda)
    before = dict(cuda_pell.LAUNCHES)
    y = spmv(A, x)
    assert cuda_pell.LAUNCHES["pell_step_grouped"] == before["pell_step_grouped"] + 1
    assert cuda_pell.LAUNCHES["pell_step_unit"] == before["pell_step_unit"]
    assert _rel(y, A.to("cpu").matvec(x.cpu()).to(cuda)) <= BOUND[torch.float32]
    with pytest.raises(TypeError):
        cuda_pell.pell_step(A, torch.zeros(A.n_x, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        cuda_pell.pell_step(A, x[:100].contiguous())


def _sparse_groups(chunks, n=6000, seed=8):
    """Whole empty 128-row groups, empty rows, and one row touching
    ``chunks`` chunks alone in its group, so that group fills K = chunks
    (past 32 a group spans two of K4's 32-slot items) while the others use
    a few slots."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(np.arange(1024, n), 600)  # rows 0..1023 stay empty
    rows = rows[rows // 128 != 2000 // 128]
    cols = np.clip(rows + rng.integers(-40, 41, rows.shape), 0, n - 1)
    a = sp.csr_matrix((rng.standard_normal(rows.shape), (rows, cols)), (n, n)).tolil()
    for c in range(chunks):
        a[2000, 128 * c + 5] = 1.0 + c
    a = sp.csr_matrix(a)
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["sparse_groups", "two_items", "band"])
def test_k4_skips_only_padding_slots(cuda, case, dtype):
    chunks = {"sparse_groups": 24, "two_items": 40}.get(case)
    a = _pell_matrix(20_000 + 11, seed=9) if chunks is None else _sparse_groups(chunks)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    A = pell.PellMatrix.from_scipy(a.astype(npdt), tile=512, encoding="unit", device=cuda)
    counts = A.slot_count.cpu()
    if chunks is not None:
        assert (counts == 0).any() and int(counts.max()) == A.k_slots == chunks
    n = a.shape[0]
    rng = np.random.default_rng(10)
    x = torch.zeros(A.n_x, dtype=dtype, device=cuda)
    vp = torch.zeros_like(x)
    x[:n] = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    vp[:n] = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    for v_prev, d, sb in ((vp, 0.7, -0.3), (None, -0.2, 0.0)):
        before = cuda_pell.LAUNCHES["pell_step_unit"]
        y = cuda_pell.pell_step(A, x, v_prev, d, sb)
        assert cuda_pell.LAUNCHES["pell_step_unit"] == before + 1
        assert _rel(y, pell.pell_step_ref(A, x, v_prev, d, sb)) <= BOUND[dtype]
    # a count that covers every slot reads the zeros too, with the same result
    full = dataclasses.replace(A, slot_count=torch.full_like(A.slot_count, A.k_slots))
    torch.testing.assert_close(cuda_pell.pell_step(full, x), cuda_pell.pell_step(A, x),
                               rtol=BOUND[dtype], atol=BOUND[dtype] * float(x.abs().max()))
    torch.cuda.synchronize()


# (offsets, nq, s, with coefficients, with x_prev, expected route): the
# register kernel at 3/9/16 diagonals, carry 2, nq below and not a multiple
# of the tile, s = 1 and 8; the shared-memory fallback past 16 diagonals;
# the chained single steps when no s-step window fits.
K3_CASES = {
    "carry2": ((-16, -9, -1, 0, 1, 9, 16), 1000, 8, True, False, "reg"),
    "nq_below_tq": (tuple(range(-4, 5)), 100, 8, True, True, "reg"),
    "one_step": ((-2, 0, 3), 5003, 1, True, True, "reg"),
    "monomial": ((-1, 0, 1), 3001, 8, False, False, "reg"),
    "x_prev_16": (tuple(range(-8, 8)), 10_007, 8, True, True, "reg"),
    "many_diagonals": (tuple(range(-10, 11)), 4099, 8, True, True, "smem"),
    "chained": ((-900, -1, 0, 1, 900), 8192, 4, True, True, "chain"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_matches_plain(cuda, case, dtype):
    offsets, nq, s, with_coefs, with_prev, route = K3_CASES[case]
    n = 8 * nq
    plan = cuda_ilv.ilv_plan(len(offsets), cuda_ilv.max_carry(offsets), s, dtype)
    assert route == ("chain" if plan is None else "reg" if plan.reg else "smem")
    D, X = _operands(n, offsets, dtype, cuda, seed=11)
    P = X.flip(0).contiguous() if with_prev else None
    c = (np.stack([np.linspace(-0.3, 0.3, s), np.r_[0.0, np.full(s - 1, 0.01)]], 1)
         if with_coefs else None)
    D_il = cuda_ilv.IlvDiaMatrix.from_dia(DiaMatrix(data=D, offsets=offsets)).data_il
    X_il = cuda_ilv.ilv_encode(X).contiguous()
    P_il = None if P is None else cuda_ilv.ilv_encode(P).contiguous()
    before = cuda_ilv.LAUNCHES["dia_powers_ilv"]
    V, last = cuda_ilv.dia_powers_ilv(D_il, X_il, c, offsets, s, P_il)
    assert cuda_ilv.LAUNCHES["dia_powers_ilv"] == before + (s if route == "chain" else 1)
    Vr, lr = cuda_ilv.dia_powers_ilv_ref(D_il, X_il, c, offsets, s, P_il)
    assert _rel(V, Vr) <= BOUND[dtype] and _rel(last, lr) <= BOUND[dtype]
    torch.cuda.synchronize()


# (offsets, n, s, with coefficients, expected kernel): the register kernel
# at 3/9/16/17 diagonals with n % 4 != 0, n below one tile, a ragged last
# tile, s = 1 and 8, monomial steps and asymmetric offsets; the
# shared-memory fallback for a wider band, more diagonals and a repeated
# offset.
K1_CASES = {
    "tri_ragged_tile": ((-1, 0, 1), 1_000_004, 8, True, "reg"),
    "nine_n_odd": (tuple(range(-4, 5)), 100_003, 8, True, "reg"),
    "below_tile": ((-1, 0, 1), 777, 8, True, "reg"),
    "tiny": (tuple(range(-4, 5)), 3, 8, True, "reg"),
    "one_step": ((-2, 0, 3), 50_001, 1, True, "reg"),
    "monomial": ((-1, 0, 1), 40_000, 8, False, "reg"),
    "asym": ((-3, 0, 2), 65_548, 8, True, "reg"),
    "nd16": (tuple(range(-8, 8)), 30_002, 8, True, "reg"),
    "nd17": (tuple(range(-8, 9)), 30_001, 4, True, "reg"),
    "wide_band": ((-20, -1, 0, 1, 20), 30_000, 4, True, "smem"),
    "many_diagonals": (tuple(range(-10, 11)), 20_000, 8, True, "smem"),
    "repeated": ((-1, 0, 0, 1), 10_000, 8, True, "smem"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_matches_plain(cuda, case, dtype):
    offsets, n, s, with_coefs, variant = K1_CASES[case]
    assert cuda_spmv.k1_plan_for(offsets, s, dtype).variant == variant
    D, X = _operands(n, offsets, dtype, cuda, seed=12)
    c = (np.stack([np.linspace(-0.3, 0.3, s), np.r_[0.0, np.full(s - 1, 0.01)]], 1)
         if with_coefs else None)
    before = dict(cuda_spmv.LAUNCHES)
    V, last = cuda_spmv.dia_powers_fused(D, X, c, offsets, s)
    assert cuda_spmv.LAUNCHES["dia_powers_fused"] == before["dia_powers_fused"] + 1
    key = "dia_powers_" + variant
    assert cuda_spmv.LAUNCHES[key] == before[key] + 1
    Vr, lr = cuda_spmv.dia_powers_fused_ref(D, X, c, offsets, s)
    assert _rel(V, Vr) <= BOUND[dtype] and _rel(last, lr) <= BOUND[dtype]
    torch.cuda.synchronize()


# Complex vectors on real planes run K2/K1 on their real and imaginary
# parts (cuda_spmv.by_parts): two launches where a real vector takes one.
def _periodic(n):
    return (-(n - 1), -(n - 2), -2, -1, 0, 1, 2, n - 2, n - 1)


def _complex_operands(n, offsets, dtype, device, seed):
    D, X = _operands(n, offsets, dtype, device, seed)
    for d, k in enumerate(offsets):  # zero where the column is out of range
        if k > 0:
            D[d, n - k:] = 0
        elif k < 0:
            D[d, :-k] = 0
    Y = _operands(n, offsets, dtype, device, seed + 1)[1]
    return DiaMatrix(data=D, offsets=offsets), torch.complex(X, Y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("band", ["tri", "periodic"])
def test_k2_on_complex_vectors(cuda, dtype, band):
    n = 100_003
    offsets = (-1, 0, 1) if band == "tri" else _periodic(n)
    A, Z = _complex_operands(n, offsets, dtype, cuda, seed=13)
    before = cuda_spmv.LAUNCHES["dia_power_step"]
    y = spmv(A, Z)
    assert cuda_spmv.LAUNCHES["dia_power_step"] == before + 2
    assert y.dtype == Z.dtype
    ref = A.matvec(Z)
    assert _rel(torch.view_as_real(y).T, torch.view_as_real(ref).T) <= BOUND[dtype]
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["newton", "monomial", "steps"])
def test_k1_on_a_complex_q(cuda, dtype, kind):
    from ca_lanczos_tpu_torch.ops import matrix_powers as mp

    n, s = 200_003, 6
    offsets = _periodic(n) if kind == "steps" else tuple(range(-4, 5))
    A, Z = _complex_operands(n, offsets, dtype, cuda, seed=14)
    B = np.eye(s + 1)[:, 1:]
    if kind != "monomial":
        B[np.arange(s), np.arange(s)] = np.linspace(-0.3, 0.3, s)
        B[np.arange(s - 1), np.arange(1, s)] = 0.01
    before = dict(cuda_spmv.LAUNCHES)
    V = (mp.matrix_powers_monomial(A, Z, s) if kind == "monomial"
         else mp.matrix_powers_from_B(A, Z, B))
    fused = cuda_spmv.LAUNCHES["dia_powers_fused"] - before["dia_powers_fused"]
    steps = cuda_spmv.LAUNCHES["dia_power_step"] - before["dia_power_step"]
    assert (fused, steps) == ((0, 2 * s) if kind == "steps" else (2, 0))
    diag, sub = mp._diag_sub(B, s)
    Vr, _ = cuda_spmv.three_term_ref(A.matvec, Z, np.stack([diag, sub], 1), s)
    got = V[:, 1:].T
    assert _rel(torch.view_as_real(got).transpose(1, 2),
                torch.view_as_real(Vr).transpose(1, 2)) <= BOUND[dtype]
    torch.cuda.synchronize()
