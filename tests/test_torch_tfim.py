"""PyTorch port on the transverse-field Ising chain (the benchmark's
``tfim-chain22`` recipe, ``benchmark/matrices/tfim_chain.py``), against the
free-fermion reference (``benchmark/reference/tfim_free_fermion.py``).

* ``solve_auto`` on the PELL route with the ``polish10`` traffic's
  arguments: the values against the exact levels, the vectors by
  Davis and Kahan's residual bound, the polish on f64 DIA planes built
  from the raw matrix (``POLISH_PREP["raw_dia"]``);
* the route's encode: a ``route.encode`` span around the host encode and
  a ``route.copy`` span with the encoder's choice as its args,
  ``ops.pell.ENCODED`` counting one encoding per PELL route, and the
  planes bit for bit the JAX package's encoder's;
* the polish goes on while a wanted pair has not settled to the f32 level
  (``solvers.polish.polish_block``), and ``solve_auto`` reports
  ``converged`` False for a pair that does not: forced by a locked block
  with one wanted level missing.
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse.linalg as sla
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from ca_lanczos_tpu.ops import pell as jpell
from ca_lanczos_tpu_torch.config import LanczosConfig
from ca_lanczos_tpu_torch.harness import auto
from ca_lanczos_tpu_torch.ops import formats, pell
from ca_lanczos_tpu_torch.solvers import polish
from ca_lanczos_tpu_torch.solvers.fused_restarted import FusedRestartedResult
from ca_lanczos_tpu_torch.utils import spans
from tests.test_torch_pell import pin_encoder

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
REF = harness.load_module(BENCH / "reference" / "tfim_free_fermion.py")
POLISH10 = harness.load_json(BENCH / "traffic" / "polish10.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread: the solves' rounding, and so their restarts, repeat."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chain(L, gauge=None):
    """The cell's chain (J = 1, h = 2.5, b = 1) on 2^L rows, f32, in the
    gauge of seed ``gauge`` as the benchmark builds it."""
    cfg = dict(harness.load_json(BENCH / "configs" / "tfim-chain22.json"))
    return harness.build_matrix(cfg, 0 if gauge is None else gauge, n=1 << L)


def settle_bound(a):
    """``_SETTLE`` u ||A||, ||A|| bounded by the largest absolute row sum."""
    return polish._SETTLE * 2.0**-24 * float(np.max(abs(a.astype(np.float64)).sum(axis=1)))


def polish10(a, seed, **kw):
    t = POLISH10
    cfg = LanczosConfig(n_wanted=t["n_wanted"], s=t["s"], tol=t["tol"],
                        max_restarts=t["max_restarts"])
    return auto.solve_auto(a, harness.signature(a.shape[0], seed), t["max_lanczos"], cfg,
                           engine=t["engine"], which=t["which"], polish=t["polish"],
                           over_lock=t["over_lock"], device="cpu", **kw)


@pytest.mark.parametrize("seed", [2**31 + 1, 7])
def test_solve_auto_on_the_pell_route_meets_the_free_fermion_levels(seed):
    a = chain(13, seed)
    before = dict(polish.POLISH_PREP)
    res = polish10(a, seed, prefer="pell")
    assert polish.POLISH_PREP["raw_dia"] == before["raw_dia"] + 1
    assert polish.POLISH_PREP["device_upcast"] == before["device_upcast"]
    assert res.route.format == "pell" and res.converged and res.n_restarts <= 200
    assert res.polish_passes >= POLISH10["polish"]
    ref = REF.top_pairs(a, 10)
    got = REF.judge(ref, res.eigs, res.Q_conv.double().numpy(), np.zeros(10))
    assert got["eig_err"] < 1e-12 and got["vec_err"] < 1e-3, got
    assert np.all(res.polish_resid <= settle_bound(a))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_route_encode_span_counter_and_planes(path, monkeypatch):
    pin_encoder(monkeypatch, path)
    a = chain(10, 3)
    before = dict(pell.ENCODED)
    args, real = {}, spans.span

    def span(name, a=None):
        args[name] = a
        return real(name, a)

    monkeypatch.setattr(spans, "span", span)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        A, route = formats.make_operator(a, prefer="pell", encoding="auto", device="cpu")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count(spans.PREFIX + "route.encode") == 1
    assert names.count(spans.PREFIX + "route.copy") == 1
    assert args["route.encode"] == "auto"
    assert args["route.copy"] == f"{A.enc} n_win={A.n_win} k_slots={A.k_slots} {path}"
    assert route.format == "pell"
    assert pell.ENCODED[A.enc] == before[A.enc] + 1
    assert sum(pell.ENCODED.values()) == sum(before.values()) + 1
    # the same bits as the JAX package's encoder, which encodes and places
    # the planes in one call
    J = jpell.PellMatrix.from_scipy(a, encoding="auto")
    assert (J.enc, J.n_win, J.k_slots, J.sw) == (A.enc, A.n_win, A.k_slots, A.sw)
    for name in ("vals", "lidx", "cbase", "span_row"):
        assert np.array_equal(np.asarray(getattr(J, name)), getattr(A, name).numpy()), name
    # without a profiler: no span, the same count
    formats.make_operator(a, prefer="pell", encoding="auto", device="cpu")
    assert pell.ENCODED[A.enc] == before[A.enc] + 2


def locked_block(a, missing=9, k=13):
    """The top ``k`` eigenvectors of ``a`` in f32, with column ``missing``
    replaced by a random vector: a locked block that lacks one wanted
    level, as the fused solve can lock it."""
    w, V = sla.eigsh(a.astype(np.float64), k=k, which="LA", tol=1e-12)
    order = np.argsort(-w)
    V = V[:, order]
    V[:, missing] = np.random.default_rng(1).standard_normal(a.shape[0])
    return w[order], torch.as_tensor(V, dtype=torch.float32)


def test_polish_goes_on_until_the_wanted_pairs_settle(monkeypatch):
    a = chain(11)
    _, Q = locked_block(a)
    w, resid, Q1 = polish.f64_operator(a, None, None, "largest", device="cpu")[0](Q, 10, 4)
    bound = settle_bound(a)
    assert resid[9] > 10 * bound and np.all(resid[:9] <= bound)  # the fault
    ref = REF.top_pairs(a, 10)
    got = REF.judge(ref, w[:10], Q1[:, :10].double().numpy(), np.zeros(10))
    assert got["eig_err"] > 1e-7 and got["vec_err"] > 1e-1
    w2, r2, Q2, passes, settled = polish.polish_block(a, None, None, Q, "largest", 10, 4, 10,
                                                      device="cpu")
    assert settled and 10 < passes <= 10 + polish._SETTLE_PASSES
    assert np.all(r2[:10] <= bound)
    got = REF.judge(ref, w2[:10], Q2[:, :10].double().numpy(), np.zeros(10))
    assert got["eig_err"] < 1e-10 and got["vec_err"] < 1e-2
    monkeypatch.setattr(polish, "_SETTLE_PASSES", 0)
    *_, passes, settled = polish.polish_block(a, None, None, Q, "largest", 10, 4, 10,
                                              device="cpu")
    assert passes == 10 and not settled


def test_solve_auto_reports_an_unsettled_pair(monkeypatch):
    a = chain(11)
    w, Q = locked_block(a)

    def locked(solver, A, r, max_lanczos, cfg, engine="host", cycles_per_call=None):
        return FusedRestartedResult(eigs=w, Q_conv=Q, nconv=13, n_restarts=1, converged=True)

    monkeypatch.setattr(auto, "_run", locked)
    res = polish10(a, 5, prefer="pell")
    assert res.converged and res.polish_passes > 10
    monkeypatch.setattr(polish, "_SETTLE_PASSES", 0)
    res = polish10(a, 5, prefer="pell")
    assert not res.converged and res.polish_passes == 10
    assert res.polish_resid[9] > settle_bound(a)


def test_a_deeper_pass_gives_the_bits_of_one_built_in_one_piece(monkeypatch):
    """A pass deeper than ``polish.DEPTH`` applies the f64 operator k
    columns at a time (memory); each column is the same product."""
    a = chain(10)
    _, Q = locked_block(a)
    A64 = formats.dia_from_scipy(a, max_diags=48, waste_cap=np.inf, dtype=np.float64,
                                 device="cpu")
    got = polish.rayleigh_ritz_polish(A64, Q, iters=1, depth=8)
    monkeypatch.setattr(polish, "DEPTH", 8)
    want = polish.rayleigh_ritz_polish(A64, Q, iters=1, depth=8)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
