"""PyTorch port: complex vectors on a real DIA operator go through the DIA
kernels by real and imaginary parts (``ops.cuda_spmv.by_parts``): ``spmv``'s
DIA kernel entry ``dia_matvec`` runs K2 twice, and ``matrix_powers`` /
``matrix_powers_from_B`` / ``matrix_powers_monomial`` of a complex q with
real coefficients run K1 (or K2 steps where ``k1_plan_for`` says "steps",
as for the periodic offsets +-(n-1)) on each part.  On the CPU the
wrappers take their plain versions, so this checks the dispatch (which
wrapper is called, how often) and the numbers; the launches on the card
are tests/test_torch_cuda_kernels.py's.  A complex shift keeps the plain
scan.

Tolerance: 1e-13 relative to max|plain| against the plain product / scan
and against the JAX package's ``spmv`` / ``matrix_powers_from_B``
(complex128 vectors, float64 planes)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_from_B as jfrom_B
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_monomial as jmono
from ca_lanczos_tpu.ops.spmv import DiaMatrix as JDia
from ca_lanczos_tpu.ops.spmv import spmv as jspmv_fn
from ca_lanczos_tpu_torch.basis.newton import newton_basis_matrix
from ca_lanczos_tpu_torch.config import Basis
from ca_lanczos_tpu_torch.ops import cuda_spmv
from ca_lanczos_tpu_torch.ops import matrix_powers as mp
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy

tspmv = importlib.import_module("ca_lanczos_tpu_torch.ops.spmv")
TOL = 1e-13
N = 2000
PERIODIC = (-(N - 1), -(N - 2), -2, -1, 0, 1, 2, N - 2, N - 1)
BANDS = {"band": (-2, -1, 0, 1, 2), "periodic": PERIODIC}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def calls(monkeypatch):
    """Count the kernel wrappers' calls (on the CPU they run their plain
    versions)."""
    counts = {"dia_power_step": 0, "dia_powers_fused": 0}
    for name in counts:
        real = getattr(cuda_spmv, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(cuda_spmv, name, counted)
    return counts


def _operator(offsets, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), N))
    for d, k in enumerate(offsets):  # zero where the column is out of range
        if k > 0:
            data[d, N - k:] = 0
        elif k < 0:
            data[d, :-k] = 0
    Aj = JDia(data=jnp.asarray(data), offsets=offsets)
    return Aj, operator_from_numpy(Aj, device="cpu")


def _q(seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(N) + 1j * rng.standard_normal(N)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("band", sorted(BANDS))
def test_complex_matvec_runs_k2_by_parts(calls, band):
    Aj, A = _operator(BANDS[band])
    q = _q()
    got = cuda_spmv.dia_matvec(A, torch.as_tensor(q))
    assert calls["dia_power_step"] == 2 and got.dtype == torch.complex128
    assert _rel(got.numpy(), A.matvec(torch.as_tensor(q)).numpy()) <= TOL
    assert _rel(got.numpy(), np.asarray(jspmv_fn(Aj, jnp.asarray(q)))) <= TOL
    # spmv on the CPU is the plain product, the same numbers
    assert _rel(tspmv.spmv(A, torch.as_tensor(q)).numpy(), got.numpy()) <= TOL
    # complex64 on float64 planes is not of their precision: plain product
    calls["dia_power_step"] = 0
    cuda_spmv.dia_matvec(A, torch.as_tensor(q, dtype=torch.complex64))
    assert calls["dia_power_step"] == 0


@pytest.mark.parametrize("band", sorted(BANDS))
@pytest.mark.parametrize("kind", ["newton", "monomial"])
def test_complex_powers_run_the_kernels_by_parts(calls, band, kind):
    offsets = BANDS[band]
    Aj, A = _operator(offsets, seed=2)
    q = _q(3)
    s = 6
    B = (newton_basis_matrix(np.linspace(-1.0, 1.0, s), s, modified=False)
         if kind == "newton" else np.eye(s + 1)[:, 1:])
    qt = torch.as_tensor(q)
    steps = cuda_spmv.k1_plan_for(offsets, s, torch.float64).variant == "steps"
    assert steps == (band == "periodic")
    for fn in (lambda: mp.matrix_powers(A, qt, s, B, Basis(kind)),
               lambda: mp.matrix_powers_from_B(A, qt, B)):
        calls.update(dia_power_step=0, dia_powers_fused=0)
        V = fn()
        want = (2 * s, 0) if steps else (0, 2)
        assert (calls["dia_power_step"], calls["dia_powers_fused"]) == want
        assert V.dtype == torch.complex128 and tuple(V.shape) == (N, s + 1)
        diag, sub = mp._diag_sub(B, s)
        plain = mp._newton_scan(A, qt, s, torch.as_tensor(diag, dtype=qt.dtype),
                                torch.as_tensor(sub, dtype=qt.dtype))
        assert _rel(V.numpy(), plain.numpy()) <= TOL
        assert _rel(V.numpy(), np.asarray(jfrom_B(Aj, jnp.asarray(q), B))) <= TOL
    if kind == "monomial":
        calls.update(dia_power_step=0, dia_powers_fused=0)
        V = mp.matrix_powers_monomial(A, qt, s)
        assert calls["dia_power_step"] + calls["dia_powers_fused"] > 0
        assert _rel(V.numpy(), np.asarray(jmono(Aj, jnp.asarray(q), s))) <= TOL


def test_complex_shifts_keep_the_plain_scan(calls):
    Aj, A = _operator(BANDS["band"], seed=4)
    q = torch.as_tensor(_q(5))
    shifts = np.array([0.5 + 0.2j, 0.5 - 0.2j, -0.3 + 0.1j, -0.3 - 0.1j])
    B = newton_basis_matrix(shifts, 4, modified=False)
    assert np.iscomplexobj(B)
    V = mp.matrix_powers(A, q, 4, B, Basis.NEWTON)
    V2 = mp.matrix_powers_newton(A, q, 4, shifts)
    assert calls == {"dia_power_step": 0, "dia_powers_fused": 0}
    assert _rel(V.numpy(), np.asarray(jfrom_B(Aj, jnp.asarray(q.numpy()), B))) <= TOL
    assert _rel(V2.numpy(), V.numpy()) <= TOL
