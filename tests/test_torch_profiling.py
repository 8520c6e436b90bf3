"""PyTorch port, utils/profiling.py and utils/debug.py against the JAX
package (CPU); mirrors tests/test_checkpoint_profiling.py::TestRoofline.

Tolerances: ``roofline_audit`` equals JAX's field by field at the same
``hbm_bw`` (the same integer and float arithmetic); the measures return a
rate > 0 (a CPU rate is no device figure); one fused CA iteration equals
JAX's (sum of the new carry column, float64) to 1e-10, and the three
kernels' iterations agree with each other to 1e-10 once decoded."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ca_lanczos_tpu.utils import debug as jdebug
from ca_lanczos_tpu.utils import profiling as jprof
from ca_lanczos_tpu.utils.matrices import laplacian_1d as jlap
from ca_lanczos_tpu_torch.ops.cuda_ilv import ilv_decode
from ca_lanczos_tpu_torch.utils import profiling
from ca_lanczos_tpu_torch.utils.debug import assert_finite, check_deterministic
from ca_lanczos_tpu_torch.utils.matrices import laplacian_1d


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_roofline_audit_matches_jax(dt):
    A = laplacian_1d(4096, dtype=getattr(torch, dt), device="cpu")
    Aj = jlap(4096, dtype=getattr(jnp, dt))
    rep = profiling.roofline_audit(A, measured_nnz_per_s=1e9, hbm_bw=jprof.DEFAULT_HBM_BW)
    assert dataclasses.asdict(rep) == dataclasses.asdict(
        jprof.roofline_audit(Aj, measured_nnz_per_s=1e9))
    assert str(rep) == str(jprof.roofline_audit(Aj, measured_nnz_per_s=1e9))
    assert rep.nnz == 3 * 4096
    assert rep.bytes_per_step == 5 * 4096 * A.data.element_size()
    assert 0 < rep.fraction_of_peak < 1 and "speed of light" in str(rep)
    # the port's default is the H100's 3.35 TB/s
    base = profiling.roofline_audit(A)
    assert base.sol_nnz_per_s == 3.35e12 / rep.bytes_per_step * rep.nnz
    assert base.measured_nnz_per_s is None


@pytest.mark.parametrize("use_pallas", [True, False])
def test_measure_powers_runs_on_cpu(use_pallas):
    A = laplacian_1d(2048, dtype=torch.float32, device="cpu")
    rate = profiling.measure_powers_throughput(A, s=2, reps_lo=1, reps_hi=3, trials=1,
                                               use_pallas=use_pallas)
    assert rate > 0


@pytest.mark.parametrize("kernel", ["roll", "ilv", "ilv_rm"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_ca_iteration_throughput_runs(kernel, use_pallas):
    A = laplacian_1d(2048, dtype=torch.float32, device="cpu")
    rate = profiling.measure_ca_iteration_throughput(A, s=2, blocks_lo=1, blocks_hi=3,
                                                     trials=1, kernel=kernel,
                                                     use_pallas=use_pallas)
    assert rate > 0


def test_ca_iteration_is_jax_iteration():
    """One fused iteration of each kernel's chain: the new carry block is
    orthonormal, "ilv"/"ilv_rm" decode to "roll"'s block, and the sum of
    its last column (what the JAX chain returns) equals JAX's."""
    n, s = 2048, 4
    A = laplacian_1d(n, device="cpu")
    blocks = {}
    for kernel in ("roll", "ilv", "ilv_rm"):
        Q0, step = profiling._ca_chain(A, s, kernel, True)
        Q1 = step(Q0)
        blocks[kernel] = (ilv_decode(Q1.T if kernel == "ilv_rm" else Q1) if kernel != "roll"
                          else Q1)
    Q = blocks["roll"]
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(s + 1), atol=1e-10)
    for k in ("ilv", "ilv_rm"):
        np.testing.assert_allclose(blocks[k].numpy(), Q.numpy(), rtol=0, atol=1e-10)
    Q0j = jnp.asarray(np.linalg.qr(np.random.default_rng(0).standard_normal((n, s + 1)))[0])
    want = float(jprof._ca_chain(jlap(n), Q0j, s, 1, False))
    np.testing.assert_allclose(float(Q[:, -1].sum()), want, rtol=0, atol=1e-10)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "prof").glob("trace.*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())
    assert len(prof.key_averages()) > 0


def test_assert_finite_finds_a_nan_deep_inside():
    @dataclasses.dataclass
    class Box:
        a: torch.Tensor
        b: object = None

    ok = {"x": [torch.ones(2), (np.zeros(3), Box(torch.zeros(2)))], "y": None}
    assert_finite(ok)
    bad = {"x": [torch.ones(2), (np.zeros(3), Box(torch.zeros(2), {"z": torch.tensor(
        [0.0, float("nan"), float("inf")])}))]}
    with pytest.raises(FloatingPointError, match="2 non-finite values in stage"):
        assert_finite(bad, "stage")
    # the JAX package's message for the same values as numpy
    with pytest.raises(FloatingPointError, match="2 non-finite values in stage"):
        jdebug.assert_finite({"x": [np.ones(2), np.array([0.0, np.nan, np.inf])]}, "stage")


def test_check_deterministic():
    x = torch.arange(6.0)
    assert check_deterministic(lambda v: {"a": v * 2, "b": (v.sum(), None)}, x, reps=3)
    g = torch.Generator().manual_seed(0)
    assert not check_deterministic(lambda: torch.randn(4, generator=g))
    rng = np.random.default_rng(0)
    assert not jdebug.check_deterministic(lambda: rng.standard_normal(4))
