"""PyTorch port: the unit PELL encoding built on the operator's device
(``ops.pell_card``), against the host encoder ``PellMatrix.encode`` and
the JAX package's encoder.

* ``encode_for_route`` on CPU tensors (``on="cpu"``) gives the host
  encoder's statics and planes bit for bit, native and numpy, and the
  JAX package's (numpy), on the transverse-field Ising chain (L = 10;
  L = 17, whose tiles need more than 64K columns, so the window width is
  searched), a band whose n is no multiple of 1024, a matrix with empty
  rows and an empty tile, f64, a given ``sw``, and rows spread over far
  chunks (one window, and a searched width with 9 windows); under
  "auto" the route gives the JAX package's planes whether it encodes
  on the card or falls back to the host; a tile past ``max_windows``
  raises the host's ``ValueError``;
* ``grouped_bounds`` is no more than the K of either grouped planner
  (native and numpy), both geometries, on several sparsity families;
* the route: a matrix on which a grouped encoding can win under "auto"
  encodes on the host, the chain at L = 20 on the card, each counted in
  ``ops.pell.ENCODED_ON``; on a card, ``make_operator(prefer="pell")``
  gives the host's planes.

The JAX package is imported only by the tests that compare with it; on
a machine with a card and without JAX run

    python -m pytest --noconftest -m requires_cuda tests/test_torch_pell_card.py
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark import harness
from ca_lanczos_tpu_torch.ops import _pell_native, formats, pell, pell_card

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
STATICS = ("enc", "n_win", "k_slots", "sw", "nnz_count", "n", "tile")
PLANES = ("vals", "lidx", "cbase", "span_row")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chain(L):
    """The benchmark's Ising chain (``tfim-chain22``'s recipe) on 2^L rows, f32."""
    cfg = dict(harness.load_json(BENCH / "configs" / "tfim-chain22.json"))
    return harness.build_matrix(cfg, 3, n=1 << L)


def banded(n, bw, per_row, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, rows.shape), 0, n - 1)
    a = sp.csr_matrix((rng.standard_normal(rows.shape), (rows, cols)), (n, n))
    a.sum_duplicates()
    return a.astype(dtype)


def with_gaps():
    """Empty rows, and no entry in rows 1024-2047 (one empty tile)."""
    a = banded(4000, 50, 5, 2).tolil()
    a[1024:2048, :] = 0
    a[3000:3010, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


def laplacian(m, dims):
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    eye = sp.eye(m)
    terms = []
    for d in range(dims):
        f = [eye] * dims
        f[d] = t
        k = f[0]
        for g in f[1:]:
            k = sp.kron(k, g)
        terms.append(k)
    return sp.csr_matrix(sum(terms))


def spread(n, per_row, step, seed=5):
    """Row i holds columns (i + k step) mod n, k < per_row: one entry in
    each of per_row far chunks, so that grouped windows cover one chunk
    each and "auto" is certain to pick unit."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = (rows + step * np.tile(np.arange(per_row), n)) % n
    return sp.csr_matrix((rng.standard_normal(rows.shape), (rows, cols)), (n, n),
                         dtype=np.float32)


def couplings(n, seed):
    """A band with scattered entries in columns 0-63 (an arrow)."""
    a = banded(n, 100, 4, seed).tolil()
    rng = np.random.default_rng(seed)
    for i in range(0, n, 17):
        a[i, int(rng.integers(0, 64))] = 1.0
    return a.tocsr()


CASES = {
    "chain10": (lambda: chain(10), {}),
    "chain17": (lambda: chain(17), {}),
    "band_ragged": (lambda: banded(3000, 60, 6, 0), dict(tile=512)),
    "gaps": (with_gaps, {}),
    "band_f64": (lambda: banded(5000, 300, 8, 1, np.float64), {}),
    "sw_given": (lambda: banded(5000, 300, 8, 1), dict(sw=2048)),
    "spread": (lambda: spread(16384, 16, 1024), {}),
    "spread_windows": (lambda: spread(70000, 8, 9000), {}),
}
# the cases on which "auto" is certain to pick unit, so the route encodes on the card
AUTO_ON_CARD = {"spread", "spread_windows"}


def same(host, card):
    for f in STATICS:
        assert getattr(host, f) == getattr(card, f), f
    for f in PLANES:
        h, c = pell._np(getattr(host, f)), pell._np(getattr(card, f))
        assert h.dtype == c.dtype and np.array_equal(h, c), f


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_planes_are_the_host_planes(case, native):
    if native:
        assert _pell_native.available(), "the native PELL encoder builds with g++ -fopenmp"
    build, kw = CASES[case]
    a = build()
    host = pell.PellMatrix.encode(a, encoding="unit", native=native, **kw)
    card = pell_card.encode_for_route(a, "cpu", encoding="unit", on="cpu", **kw)
    assert card.encoder == "card"
    same(host, card)


def jax_encode(a, encoding, **kw):
    """The JAX package's planes of ``a`` (its numpy encoder)."""
    from ca_lanczos_tpu.ops import pell as jpell

    return jpell.PellMatrix.from_scipy(a, encoding=encoding, device=False, native=False, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_card_planes_are_the_jax_planes(case):
    build, kw = CASES[case]
    a = build()
    card = pell_card.encode_for_route(a, "cpu", encoding="unit", on="cpu", **kw)
    assert card.encoder == "card"
    same(jax_encode(a, "unit", **kw), card)


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_auto_planes_are_the_jax_planes(case, monkeypatch):
    """Under "auto" the route gives the JAX package's planes, on the card
    where the bound settles the pick, else from the host encoder (its
    numpy path, as the JAX package's here: the native planners assign
    grouped slots in another order)."""
    monkeypatch.setattr(_pell_native, "_load", lambda: None)
    build, kw = CASES[case]
    a = build()
    before = dict(pell.ENCODED_ON)
    got = pell_card.encode_for_route(a, "cpu", encoding="auto", on="cpu", **kw)
    where = "card" if case in AUTO_ON_CARD else "host"
    assert pell.ENCODED_ON == {**before, where: before[where] + 1}
    assert (got.encoder == "card") == (where == "card")
    same(jax_encode(a, "auto", **kw), got)


def test_chain17_searches_the_window_width():
    a = chain(17)
    plan = pell_card.plan_unit(pell_card._csr(a), "cpu")
    assert plan.sw < pell.SW_MAX < a.shape[0]
    assert plan.span_row.shape[1] > 1


@pytest.mark.parametrize("encoding", ["unit", "auto"])
def test_window_overflow_raises_the_host_error(encoding):
    a = banded(6000, 1500, 6, 4)
    kw = dict(sw=1024, max_windows=2, encoding=encoding)
    with pytest.raises(ValueError, match="PELL window overflow") as host:
        pell.PellMatrix.encode(a, **kw)
    with pytest.raises(ValueError) as card:
        pell_card.encode_for_route(a, "cpu", on="cpu", **kw)
    assert str(card.value) == str(host.value)


FAMILIES = {
    "chain12": lambda: chain(12),
    "chain14": lambda: chain(14),
    "band": lambda: banded(6000, 40, 5, 0),
    "band_wide": lambda: banded(6000, 200, 12, 1),
    "laplacian2d": lambda: laplacian(60, 2),
    "laplacian3d": lambda: laplacian(24, 3),
    "couplings": lambda: couplings(6144, 3),
    "blocks": lambda: sp.csr_matrix(sp.block_diag([np.ones((16, 16))] * 256)),
    "spread": lambda: spread(12000, 16, 1024),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_grouped_bound_is_below_both_planners(family):
    assert _pell_native.available()
    csr = pell_card._csr(FAMILIES[family]())
    plan = pell_card.plan_unit(csr, "cpu")
    bounds = pell_card.grouped_bounds(plan)
    n, sr = csr.shape[0], plan.sw // pell.LANES
    counts = plan.n_win_of.numpy()
    starts = plan.span_row.numpy()
    wins = [starts[t, :c].astype(np.int64) for t, c in enumerate(counts)]
    c = _pell_native._Csr(csr.indptr, csr.indices, csr.data, np.float32)
    planned = 0
    for g, (nw, _) in pell.GROUPED_GEOM.items():
        native = _pell_native.plan_grouped(c, n, plan.tile, sr, starts, counts.astype(np.int32),
                                           nw=nw)
        numpy = pell._encode_grouped(csr.indptr, csr.indices, csr.data, n, plan.tile, wins,
                                     plan.sw, np.float32, geom=g)
        for got in (native, numpy):
            if got is not None:
                assert bounds[g] <= got[3], (g, bounds[g], got[3])
                planned += 1
    assert planned


def test_route_falls_back_to_the_host_where_grouped_can_win():
    a = laplacian(60, 2)
    host = pell.PellMatrix.encode(a, encoding="auto")
    assert host.enc != "unit"
    before = dict(pell.ENCODED_ON)
    got = pell_card.encode_for_route(a, "cpu", encoding="auto", on="cpu")
    assert pell.ENCODED_ON == {**before, "host": before["host"] + 1}
    assert got.encoder != "card"
    same(host, got)


def test_route_encodes_the_chain_on_the_card():
    a = chain(20)
    host = pell.PellMatrix.encode(a, encoding="auto")
    before, enc = dict(pell.ENCODED_ON), dict(pell.ENCODED)
    got = pell_card.encode_for_route(a, "cpu", encoding="auto", on="cpu")
    assert pell.ENCODED_ON == {**before, "card": before["card"] + 1}
    assert pell.ENCODED == {**enc, "unit": enc["unit"] + 1}
    assert got.encoder == "card"
    same(host, got)


def test_route_on_the_cpu_encodes_on_the_host():
    a = chain(10)
    before = dict(pell.ENCODED_ON)
    A, route = formats.make_operator(a, prefer="pell", encoding="unit", device="cpu")
    assert pell.ENCODED_ON == {**before, "host": before["host"] + 1}
    host = pell.PellMatrix.encode(a, encoding="unit").to("cpu")
    for f in PLANES + ("slot_count",):
        assert torch.equal(getattr(A, f), getattr(host, f)), f


@pytest.mark.requires_cuda
def test_make_operator_on_a_card_gives_the_host_planes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the route encodes on the host without one)")
    a = chain(20)
    host = pell.PellMatrix.encode(a, encoding="auto")
    before = dict(pell.ENCODED_ON)
    A, route = formats.make_operator(a, prefer="pell", encoding="auto", device="cuda")
    assert pell.ENCODED_ON == {**before, "card": before["card"] + 1}
    assert A.device.type == "cuda"
    for f in STATICS[1:] + ("enc",):
        assert getattr(A, f) == getattr(host, f), f
    for f in PLANES:
        assert np.array_equal(getattr(A, f).cpu().numpy(), getattr(host, f)), f
    assert torch.equal(A.slot_count, host.to("cuda").slot_count)
