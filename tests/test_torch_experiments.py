"""PyTorch port, harness/experiments.py and harness/records.py against the
JAX package (``device="cpu"``, float64); mirrors
tests/test_harness.py::TestExperiments and ::TestRecords.

Tolerances: the records agree field by field — errors (max_abs_err,
max_eig_err, max_ritz_norm, max_orth_err) 1e-9 absolute, restart counts
and convergence flags equal, the configuration fields identical; wall
times only positive.  Records written by either package are read by the
other unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ca_lanczos_tpu import harness as jh
from ca_lanczos_tpu.config import Basis as JBasis
from ca_lanczos_tpu.harness.records import RunRecord as JRecord
from ca_lanczos_tpu.utils.matrices import diag_spectrum as jdiag
from ca_lanczos_tpu_torch import harness as th
from ca_lanczos_tpu_torch.config import Basis
from ca_lanczos_tpu_torch.harness.records import RunRecord
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy

ERR = 1e-9
TIMES = ("wall_s",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_records(rt, rj):
    assert len(rt) == len(rj)
    for a, b in zip(rt, rj):
        da, db = a.__dict__, b.__dict__
        assert set(da) == set(db)
        for k in da:
            if k in TIMES:
                assert da[k] > 0 and db[k] > 0
            elif k == "extra":
                assert set(da[k]) == set(db[k])
                for e in da[k]:
                    if isinstance(db[k][e], float):
                        np.testing.assert_allclose(da[k][e], db[k][e], rtol=0, atol=ERR)
                    else:
                        assert da[k][e] == db[k][e], e
            elif isinstance(db[k], float):
                np.testing.assert_allclose(da[k], db[k], rtol=0, atol=ERR, err_msg=k)
            else:
                assert da[k] == db[k], k


def test_propagation_small_matches_jax():
    kw = dict(n=64, n_steps=5, krylov_dim=12, s=3)
    rt = th.run_propagation_experiment(device="cpu", **kw)
    rj = jh.run_propagation_experiment(**kw)
    assert [r.solver for r in rt] == ["std-lanczos", "ca-newton", "ca-monomial"]
    for r in rt:
        assert r.extra["max_abs_err"] < 1e-7
    _same_records(rt, rj)


def test_propagation_baseline_ca_newton_matches_jax():
    """BASELINE's configuration (runLanczos.m: n = 512, 200 steps) for the
    CA Newton propagator: the oracle error is the JAX package's own
    (~1.1e-7, above the 1e-8 its tests hold at 20 steps), and the port's is
    the same to 1e-7 absolute; chip_smoke's phase G bounds it by 1e-6."""
    kw = dict(n=512, dt=0.025, n_steps=200, krylov_dim=24, s=6, tol=1e-10)
    rt = th.run_propagation_experiment(
        device="cpu", methods=(("ca-newton", "ca", Basis.NEWTON),), **kw)[0]
    rj = jh.run_propagation_experiment(methods=(("ca-newton", "ca", JBasis.NEWTON),), **kw)[0]
    rt, rj = rt.extra["max_abs_err"], rj.extra["max_abs_err"]
    assert 1e-8 < rj < 1e-6 and rt < 1e-6
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-7)


def test_restart_sweep_small_matches_jax():
    Aj = jdiag(200, 1.0, 50.0)
    oracles = {"diag200": np.linspace(1.0, 50.0, 200)}
    kw = dict(s_values=(4,), orths=("local",), max_lanczos=24, n_wanted=4, oracles=oracles)
    rt = th.run_restart_sweep({"diag200": operator_from_numpy(Aj, device="cpu")}, **kw)
    rj = jh.run_restart_sweep({"diag200": Aj}, **kw)
    assert len(rt) == 1 and rt[0].converged and rt[0].max_eig_err < 1e-5
    _same_records(rt, rj)


def test_restart_sweep_records_a_failure():
    """A case that raises is recorded, not fatal (max_lanczos < s)."""
    A = operator_from_numpy(jdiag(50, 1.0, 5.0), device="cpu")
    rt = th.run_restart_sweep({"d": A}, s_values=(8,), orths=("local",), max_lanczos=4,
                              n_wanted=2)
    rj = jh.run_restart_sweep({"d": jdiag(50, 1.0, 5.0)}, s_values=(8,), orths=("local",),
                              max_lanczos=4, n_wanted=2)
    assert rt[0].converged is False and "error" in rt[0].extra
    assert rj[0].converged is False and "error" in rj[0].extra


def test_convergence_traces_match_jax():
    Aj = jdiag(300, 1.0, 100.0)
    rec, rnorm, orth = th.run_convergence_experiment(operator_from_numpy(Aj, device="cpu"),
                                                     "diag300", n_iters=40, s=4)
    jrec, jrnorm, jorth = jh.run_convergence_experiment(Aj, "diag300", n_iters=40, s=4)
    assert rnorm.shape == (10, 40) and orth.shape == (10,)
    np.testing.assert_allclose(rnorm, jrnorm, rtol=0, atol=ERR)
    np.testing.assert_allclose(orth, jorth, rtol=0, atol=ERR)
    _same_records([rec], [jrec])


def test_records_roundtrip_and_interchange(tmp_path):
    recs = [
        RunRecord(matrix="m1", solver="x", s=4, max_eig_err=1e-9, extra={"foo": 1}),
        RunRecord(matrix="m2", solver="y", converged=True),
    ]
    jrecs = [JRecord(matrix="m1", solver="x", s=4, max_eig_err=1e-9, extra={"foo": 1}),
             JRecord(matrix="m2", solver="y", converged=True)]
    assert [r.to_json() for r in recs] == [r.to_json() for r in jrecs]
    pt, pj = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    th.write_records(pt, recs)
    jh.write_records(pj, jrecs)
    back = jh.read_records(pt)
    assert back == th.read_records(pj) == th.read_records(pt)
    assert back[0]["matrix"] == "m1" and back[0]["foo"] == 1
    assert back[1]["converged"] is True and "s" not in back[1]
    assert open(pt).read() == open(pj).read()
