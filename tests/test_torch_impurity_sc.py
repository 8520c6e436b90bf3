"""PyTorch port on the periodic simple-cubic lattice with deep impurities
(the benchmark's ``impurity-sc216`` recipe, ``benchmark/matrices/
impurity_sc.py``), against its Green's-function reference
(``benchmark/reference/sc_impurity.py``).

* the recipe: 6 n + 16 entries, the periodic wrap, the impurities placed;
* the reference against an independent f64 solve (dense ``eigh``, ARPACK),
  and its certificate refusing a matrix whose levels it cannot separate
  or that is not the model;
* ``solve_auto`` on the PELL route with the ``polish10`` traffic's
  arguments, where the encoder picks ``grouped4`` (K5), judged by the
  reference under the cell's limits;
* the route's spans ``route.encode.plan`` and ``route.encode.host`` and
  the counter ``ops.pell.SLOT_FILL``.
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from ca_lanczos_tpu_torch.config import LanczosConfig
from ca_lanczos_tpu_torch.harness import auto
from ca_lanczos_tpu_torch.ops import formats, pell, pell_card
from ca_lanczos_tpu_torch.solvers import polish
from ca_lanczos_tpu_torch.utils import spans
from tests.test_torch_pell import pin_encoder

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
REF = harness.load_module(BENCH / "reference" / "sc_impurity.py")
RECIPE = harness.load_module(BENCH / "matrices" / "impurity_sc.py")
CONFIG = harness.load_json(BENCH / "configs" / "impurity-sc216.json")
LIMITS = harness.load_json(BENCH / "limits" / "impurity-sc216.polish10.json")
POLISH10 = harness.load_json(BENCH / "traffic" / "polish10.json")
EPS = CONFIG["params"]["eps"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread: the solves' rounding, and so their restarts, repeat."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lattice(L, gauge=None, instance=0):
    """The cell's lattice on L^3 rows, f32, instance ``instance`` in the
    gauge of seed ``gauge`` as the benchmark builds it."""
    return harness.build_matrix(CONFIG, 0 if gauge is None else gauge, n=L ** 3,
                                recipe_seed=instance)


def kron_build(L, rows, vals):
    ring = sp.diags([np.ones(L - 1), np.ones(L - 1), [1.0], [1.0]], [1, -1, L - 1, 1 - L],
                    shape=(L, L))
    eye = sp.identity(L)
    a = (sp.kron(sp.kron(eye, eye), ring) + sp.kron(sp.kron(eye, ring), eye)
         + sp.kron(sp.kron(ring, eye), eye))
    return (a + sp.csr_matrix((vals, (rows, rows)), shape=(L ** 3,) * 2)).tocsr()


@pytest.mark.parametrize("L,instance", [(12, 0), (32, 5)])
def test_recipe_is_the_periodic_lattice_with_its_impurities(L, instance):
    n = L ** 3
    a = RECIPE.build(n, instance, 1.0, EPS, 3)
    rows, vals = RECIPE.sites(L, instance, EPS, 3)
    assert a.has_sorted_indices and a.nnz == 6 * n + 16
    assert abs(a - kron_build(L, rows, vals)).max() == 0
    # the wrap: row 0 reaches x = L-1, y = L-1 and z = L-1
    assert set(a[0].indices) == {1, L - 1, L, L * (L - 1), L * L, L * L * (L - 1)}
    assert np.array_equal(np.flatnonzero(a.diagonal()), np.sort(rows))
    assert sorted(a.diagonal()[rows]) == EPS
    # one impurity in the middle half of each drawn cell of the 3 x 3 x 3 partition
    c = L // 3
    xyz = np.stack([rows % L, rows // L % L, rows // (L * L)], axis=1)
    assert np.all((xyz % c >= c // 4) & (xyz % c < 3 * c // 4) & (xyz < 3 * c))
    assert len({tuple(p) for p in xyz // c}) == 16
    with pytest.raises(ValueError, match="L\\^3"):
        RECIPE.build(n + 1, instance, 1.0, EPS, 3)


def check_against(ref, w, U):
    """The reference's levels and vectors against an independent f64 solve
    (w descending, U its vectors)."""
    assert np.max(np.abs(ref.levels - w[:16])) <= 1e-13 * w[0]
    assert np.max(ref.resid) < 1e-9 and ref.tau < ref.theta[-1]
    out = np.sum(U[:, :10] ** 2, axis=0) - np.sum(U[ref.rows, :10] ** 2, axis=0)
    got = REF.judge(ref, w[:10], U[ref.rows, :10], out)
    assert got["eig_err"] < 1e-14 and got["vec_err"] < 1e-10, got


@pytest.mark.parametrize("gauge", [None, 2**31 + 9])
def test_reference_agrees_with_dense_eigh(gauge):
    a = lattice(12, gauge).astype(np.float64)
    ref = REF.top_pairs(a, 10)
    w, U = np.linalg.eigh(a.toarray())
    check_against(ref, w[::-1], U[:, ::-1])


def test_reference_agrees_with_arpack_at_L64():
    a = lattice(64, 7).astype(np.float64)
    ref = REF.top_pairs(a, 10)
    w, U = sla.eigsh(a, k=16, which="LA", tol=1e-14, ncv=60,
                     v0=np.random.default_rng(0).standard_normal(a.shape[0]))
    check_against(ref, w[::-1], U[:, ::-1])
    assert ref.rows.size < a.shape[0]  # the kept cubes leave rows out


def symmetric_triple(L=12):
    """Three equal impurities that the cyclic exchange of x, y and z maps
    onto each other: two of their levels are one (degenerate)."""
    rows = np.array([3, 3 * L, 3 * L * L])
    a = kron_build(L, np.concatenate([rows, [0]]), [6.0, 6.0, 6.0, 9.0])
    return a


def broken(kind):
    a = lattice(12).astype(np.float64).tolil()
    if kind == "attractive":
        r = int(np.flatnonzero(a.diagonal())[0])
        a[r, r] = -1.0
    elif kind == "hop":
        a[0, 1] = a[1, 0] = 2.0
    elif kind == "sign":  # one hop's sign flipped on one side: no gauge
        a[0, 1] = -a[0, 1]
    elif kind == "degenerate":
        a = symmetric_triple()
    return sp.csr_matrix(a)


@pytest.mark.parametrize("kind,match", [("attractive", "repulsive"), ("hop", "one hop"),
                                        ("sign", "gauge"), ("degenerate", "radii")])
def test_no_certificate_where_the_levels_cannot_be_told_apart(kind, match):
    with pytest.raises(ValueError, match=match):
        REF.top_pairs(broken(kind), 3)


def polish10(a, seed, **kw):
    t = POLISH10
    cfg = LanczosConfig(n_wanted=t["n_wanted"], s=t["s"], tol=t["tol"],
                        max_restarts=t["max_restarts"])
    return auto.solve_auto(a, harness.signature(a.shape[0], seed), t["max_lanczos"], cfg,
                           engine=t["engine"], which=t["which"], polish=t["polish"],
                           over_lock=t["over_lock"], device="cpu", **kw)


@pytest.mark.parametrize("L", [32, 64])
def test_auto_encoding_picks_grouped4(L):
    before = dict(pell.ENCODED)
    A, route = formats.make_operator(lattice(L, 3), **CONFIG["route"], device="cpu")
    assert route.format == "pell" and A.enc == "grouped4"
    assert pell.ENCODED["grouped4"] == before["grouped4"] + 1
    # prefer="auto" sends the lattice to DIA
    assert formats.make_operator(lattice(L, 3), device="cpu")[1].format == "dia"


def test_solve_auto_on_the_grouped_route_meets_the_reference():
    seed = 2**31 + 5
    a = lattice(32, seed)
    before, prep = dict(pell.ENCODED), dict(polish.POLISH_PREP)
    res = polish10(a, seed, **CONFIG["route"])
    assert pell.ENCODED["grouped4"] == before["grouped4"] + 1
    assert polish.POLISH_PREP["raw_dia"] == prep["raw_dia"] + 1
    assert res.route.format == "pell" and res.converged and res.n_restarts <= 200
    ref = REF.top_pairs(a, 10)
    Q = res.Q_conv.double().numpy()
    out = np.sum(Q ** 2, axis=0) - np.sum(Q[ref.rows] ** 2, axis=0)
    got = REF.judge(ref, res.eigs, Q[ref.rows], out)
    assert all(got[k] <= lim for k, lim in LIMITS.items()), got


def spans_of(fn, monkeypatch):
    """(result, names of the spans recorded, args of each span by name)."""
    args, real = {}, spans.span

    def span(name, a=None):
        args[name] = a
        return real(name, a)

    monkeypatch.setattr(spans, "span", span)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = [e.name()[len(spans.PREFIX):] for e in prof.profiler.kineto_results.events()
             if e.name().startswith(spans.PREFIX)]
    return out, names, args


def walked(A):
    """Plane entries K4/K5 walk, counted from the values themselves."""
    counts = pell.pell_slot_counts(A.vals, A.ntiles, A.k_slots, A.tile)
    return int(counts.clamp(max=A.k_slots).sum()) * pell.LANES


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_route_spans_and_slot_fill_counter(path, monkeypatch):
    pin_encoder(monkeypatch, path)
    a = lattice(32, 11)
    fill, on = dict(pell.SLOT_FILL), dict(pell.ENCODED_ON)
    (A, _), names, args = spans_of(
        lambda: formats.make_operator(a, prefer="pell", device="cpu"), monkeypatch)
    # the CPU route encodes on the host, without a plan
    assert names.count("route.encode") == names.count("route.encode.host") == 1
    assert "route.encode.plan" not in names and args["route.encode.host"] == "auto"
    assert pell.ENCODED_ON == {**on, "host": on["host"] + 1}
    assert pell.SLOT_FILL == {"nnz": fill["nnz"] + a.nnz, "walked": fill["walked"] + walked(A)}
    assert a.nnz < walked(A)  # padding: the fill is below 100%


@pytest.mark.parametrize("encoding", ["auto", "unit"])
def test_card_plan_span_and_where_the_encode_runs(encoding, monkeypatch):
    a = lattice(32, 13)
    on = dict(pell.ENCODED_ON)
    planes, names, args = spans_of(
        lambda: pell_card.encode_for_route(a, "cpu", encoding=encoding, on="cpu"), monkeypatch)
    assert names.count("route.encode.plan") == 1 and args["route.encode.plan"] == encoding
    plan = pell_card.plan_unit(pell_card._csr(a), "cpu")
    if encoding == "unit":  # planned and emitted on the device
        assert "route.encode.host" not in names and planes.encoder == "card"
        assert pell.ENCODED_ON == {**on, "card": on["card"] + 1}
        return
    # "auto": the bound cannot settle unit, so the host encodes, and its
    # span's args carry the plan's unit K and the grouped bounds
    bounds = pell_card.grouped_bounds(plan)
    assert not pell_card.unit_is_certain(plan, bounds) and planes.enc == "grouped4"
    assert names.index("route.encode.plan") < names.index("route.encode.host")
    assert args["route.encode.host"] == (
        f"auto unit K={plan.k_slots} bounds grouped={bounds['grouped']} "
        f"grouped4={bounds['grouped4']}")
    assert pell.ENCODED_ON == {**on, "host": on["host"] + 1}
