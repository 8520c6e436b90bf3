"""PyTorch port, general sparsity: the PELL encoders, the plain step that
stands for kernels K4/K5 on the CPU, and the routing, negation and
serialisation of a PellMatrix, against the JAX package on the same numpy
inputs.

Tolerances: the encoders must give the same bits (planes and statics);
the plain step against JAX's Pallas kernels in interpret mode agrees to
1e-6 (f32) and 1e-13 (f64) relative to max|y| per vector, since the two
sum the K slots in another order; products against scipy's f64 CSR are
1e-12 relative on f64 planes."""

import dataclasses
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from ca_lanczos_tpu.ops import _pell_native as jpell_native
from ca_lanczos_tpu.ops import formats as jformats
from ca_lanczos_tpu.ops import pell as jpell
from ca_lanczos_tpu_torch.ops import _pell_native, formats, pell, pell_card
from ca_lanczos_tpu_torch.ops.spmv import spmv
from ca_lanczos_tpu_torch.utils.interop import operator_from_numpy

FIELDS = ("vals", "lidx", "cbase", "span_row")
STATICS = ("n", "tile", "k_slots", "sw", "nnz_count", "n_win", "enc")
BOUND = {np.float32: 1e-6, np.float64: 1e-13}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pin_encoder(mp, path):
    """Put the JAX package's PELL encoder and the port's on one path, so that
    their planes can be compared bit for bit (the two encoders give valid
    planes with different slot assignments).  "numpy": both loaders report
    no library.  "native": JAX's load is retried until its library loads.
    The JAX package builds it beside its source without a temporary file,
    so a process that read the file while another test process was writing
    it has cached the failure.  ``mp`` is a ``pytest.MonkeyPatch``."""
    if path == "numpy":
        mp.setattr(jpell_native, "_load", lambda: None)
        mp.setattr(_pell_native, "_load", lambda: None)
        return
    for _ in range(120):
        mp.setattr(jpell_native, "_TRIED", False)
        mp.setattr(jpell_native, "_LIB", None)
        if jpell_native.available():
            break
        time.sleep(0.5)
    assert jpell_native.available() and _pell_native.available(), \
        "both native PELL encoders build with g++ -fopenmp"


@pytest.fixture(params=["native", "numpy"])
def encoder(request, monkeypatch):
    """Both packages on one encoder path (``pin_encoder``)."""
    pin_encoder(monkeypatch, request.param)
    return request.param


def random_banded(n, bw, per_row, seed):
    """General sparsity inside a band of half-width bw (not DIA)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, rows.shape), 0, n - 1)
    a = sp.csr_matrix((rng.standard_normal(rows.shape), (rows, cols)), (n, n))
    a.sum_duplicates()
    return a


def _patterns():
    """tests/test_pell.py's patterns: name -> (csr, from_scipy kwargs)."""
    nx = 40
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (nx, nx))
    lap2d = sp.kron(sp.eye(nx), t) + sp.kron(t, sp.eye(nx))
    n = 4096
    o = np.ones(n)
    ring = sp.diags([o, o, 4 * o, o, o], [-2, -1, 0, 1, 2], (n, n)).tolil()
    ring[0, n - 1] = ring[n - 1, 0] = 1.0
    ring[0, n - 2] = ring[n - 2, 0] = 1.0
    rng = np.random.default_rng(13)
    arrow = random_banded(6144, 100, 4, 13).tolil()
    for i in range(0, 6144, 17):  # scattered couplings to columns 0..63
        arrow[i, int(rng.integers(0, 64))] = rng.standard_normal()
    wide = sp.lil_matrix((2048, 2048))
    wide.setdiag(2.0 * np.ones(2048))
    wide[5, 100:100 + 10 * 128] = 1.0  # one row over 10 consecutive chunks
    return {
        "banded": (random_banded(2048, 40, 5, 0), dict(tile=512)),
        "lap2d": (lap2d, dict(tile=512)),
        "ring_wrap": (ring, dict(tile=1024, sw=1024)),
        "clusters": (arrow, dict(tile=1024, sw=1024)),
        "wide_cluster": (wide, dict(tile=256)),
    }


PATTERNS = _patterns()


def _csr(name):
    a, kw = PATTERNS[name]
    a = sp.csr_matrix(a)
    a.sum_duplicates()
    a.sort_indices()
    return a, kw


def _same(J, T):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(J, f)), getattr(T, f).numpy(),
                                      err_msg=f)
    assert tuple(getattr(J, f) for f in STATICS) == tuple(getattr(T, f) for f in STATICS)


def _x(n, seed=1, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("enc", ["unit", "grouped", "grouped4", "auto"])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_encoder_planes_match_jax(name, enc):
    a, kw = _csr(name)
    try:
        J = jpell.PellMatrix.from_scipy(a, encoding=enc, device=False, native=False, **kw)
    except ValueError as e:
        # forced grouped on the wide cluster: both packages refuse alike
        assert name == "wide_cluster" and enc in ("grouped", "grouped4")
        with pytest.raises(ValueError, match=str(e)):
            pell.PellMatrix.from_scipy(a, encoding=enc, device="cpu", native=False, **kw)
        return
    T = pell.PellMatrix.from_scipy(a, encoding=enc, device="cpu", native=False, **kw)
    _same(J, T)
    if name == "wide_cluster":
        assert T.enc == "unit"
    if name in ("ring_wrap", "clusters"):
        assert T.n_win >= 2
    x = _x(a.shape[0])
    y = pell.pell_apply(T, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12 * np.abs(a @ x).max())


@pytest.mark.parametrize("enc", ["unit", "auto"])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_card_encoder_planes_match_jax(name, enc, monkeypatch):
    """The route's encode on the operator's device (``ops.pell_card``, on
    CPU tensors) gives the JAX package's planes: "unit" always on the
    card; "auto" on the card where it is certain to pick unit, else on
    the host, both packages on the numpy encoder (``pin_encoder``)."""
    pin_encoder(monkeypatch, "numpy")
    a, kw = _csr(name)
    J = jpell.PellMatrix.from_scipy(a, encoding=enc, device=False, native=False, **kw)
    before = pell.ENCODED_ON["card"]
    T = pell_card.encode_for_route(a, "cpu", encoding=enc, on="cpu", **kw)
    on_card = pell.ENCODED_ON["card"] == before + 1
    assert on_card == (T.encoder == "card")
    assert on_card or enc == "auto"
    assert J.enc == "unit" or not on_card
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(J, f)), pell._np(getattr(T, f)),
                                      err_msg=f)
    assert tuple(getattr(J, f) for f in STATICS) == tuple(getattr(T, f) for f in STATICS)


@pytest.mark.parametrize("enc", ["unit", "grouped", "auto"])
@pytest.mark.parametrize("name", ["banded", "lap2d", "ring_wrap"])
def test_native_encoder_matches_numpy(name, enc):
    assert _pell_native.available(), "the native encoder builds with g++ -fopenmp"
    a, kw = _csr(name)
    Mn = pell.PellMatrix.from_scipy(a, encoding=enc, device="cpu", native=True, **kw)
    Mp = pell.PellMatrix.from_scipy(a, encoding=enc, device="cpu", native=False, **kw)
    assert (Mn.enc, Mn.k_slots, Mn.sw, Mn.n_win) == (Mp.enc, Mp.k_slots, Mp.sw, Mp.n_win)
    x = torch.as_tensor(_x(a.shape[0], seed=2))
    want = a @ x.numpy()
    for M in (Mn, Mp):
        np.testing.assert_allclose(pell.pell_apply(M, x).numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_native_encoder_float64_and_empty_rows():
    a = _csr("ring_wrap")[0]
    M = pell.PellMatrix.from_scipy(a, device="cpu", native=True)
    assert M.dtype == torch.float64
    np.testing.assert_array_equal(M.to_dense(), a.toarray())
    e = sp.csr_matrix((np.ones(3), (np.array([0, 299, 599]), np.array([0, 299, 599]))),
                      (600, 600))
    np.testing.assert_array_equal(
        pell.PellMatrix.from_scipy(e, device="cpu", native=True).to_dense(), e.toarray())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("enc", ["unit", "grouped", "grouped4"])
def test_step_and_powers_match_jax_interpret(enc, dtype):
    # the periodic wrap over two windows exercises the window decode
    n = 2048
    o = np.ones(n)
    a = sp.diags([-0.05 * o[:-1], 0.1 * o, -0.05 * o[:-1], 0.02 * o[:-3]],
                 [-1, 0, 1, 3]).tolil()
    a[0, n - 1] = a[n - 1, 0] = a[3, n - 2] = -0.05
    a = sp.csr_matrix(a).astype(dtype)
    J = jpell.PellMatrix.from_scipy(a, tile=256, sw=1024, encoding=enc, native=False)
    T = pell.PellMatrix.from_scipy(a, tile=256, sw=1024, encoding=enc, device="cpu",
                                   native=False)
    _same(J, T)
    _same(J, operator_from_numpy(J, device="cpu"))  # the JAX operator carried across
    assert T.n_win == 2
    rng = np.random.default_rng(4)
    x, vp = (rng.standard_normal(n).astype(dtype) for _ in range(2))
    d, sb = 0.7, -0.3

    def close(got, ref):
        got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        assert np.abs(got - ref).max() <= BOUND[dtype] * np.abs(ref).max()

    yj = jpell.pell_apply(J, jnp.asarray(x), jnp.asarray(vp), d, sb, interpret=True)
    yt = pell.pell_apply(T, torch.as_tensor(x), torch.as_tensor(vp), d, sb)
    assert yt.dtype == T.dtype
    close(yt.numpy(), yj)
    # the plain step on the padded vectors is the same function
    xp = torch.nn.functional.pad(torch.as_tensor(x), (0, T.n_x - n))
    vpp = torch.nn.functional.pad(torch.as_tensor(vp), (0, T.n_x - n))
    close(pell.pell_step_ref(T, xp, vpp, d, sb)[:n].numpy(), yj)
    s = 3
    diag, sub = rng.standard_normal(s) * 0.1, rng.standard_normal(s) * 0.1
    Vj = jpell.matrix_powers_pell(J, jnp.asarray(x), s, diag, sub, interpret=True)
    Vt = pell.matrix_powers_pell(T, torch.as_tensor(x), s, diag, sub)
    assert Vt.shape == (n, s + 1)
    for k in range(s + 1):
        close(Vt[:, k].numpy(), np.asarray(Vj)[:, k])


def test_vector_dtype_must_match_the_planes():
    a = _csr("banded")[0].astype(np.float32)
    T = pell.PellMatrix.from_scipy(a, tile=512, device="cpu")
    with pytest.raises(TypeError, match="dtype"):
        pell.pell_apply(T, torch.as_tensor(_x(a.shape[0])))  # float64 x
    # a complex x applies to its real and imaginary parts
    x = torch.as_tensor(_x(a.shape[0], 5, np.float32))
    z = torch.complex(x, 2 * x)
    got = spmv(T, z)
    y = T.matvec(x)
    torch.testing.assert_close(got, torch.complex(y, 2 * y))


def _scattered_band(n=8192):
    """tests/test_formats.py's scattered band: too many offsets for DIA,
    one PELL window."""
    rng = np.random.default_rng(1)
    rows = np.repeat(np.arange(n), 8)
    cols = np.clip(rows + rng.integers(-512, 512, rows.shape), 0, n - 1)
    a = sp.csr_matrix((rng.standard_normal(rows.shape), (rows, cols)), (n, n))
    a.sum_duplicates()
    return a


def test_make_operator_routes_scattered_band_to_pell(encoder):
    a = _scattered_band()
    Aj, rj = jformats.make_operator(a)
    At, rt = formats.make_operator(a, device="cpu")
    assert isinstance(At, pell.PellMatrix)
    assert rt.format == rj.format == "pell"
    assert rt.notes == rj.notes and rt.perm is None and rj.perm is None
    _same(Aj, At)
    x = _x(a.shape[0], 3)
    np.testing.assert_allclose(spmv(At, torch.as_tensor(x, dtype=At.dtype)).numpy(), a @ x,
                               rtol=1e-12, atol=1e-12 * np.abs(a @ x).max())


def test_prefer_pell_and_negate(encoder):
    a = _csr("banded")[0]
    for encoding in ("unit", "grouped"):
        Aj, rj = jformats.make_operator(a, prefer="pell", tile=512, encoding=encoding)
        At, rt = formats.make_operator(a, prefer="pell", tile=512, encoding=encoding,
                                       device="cpu")
        assert rt.format == rj.format == "pell" and rt.notes == rj.notes == ["forced pell"]
        assert At.enc == encoding
        _same(Aj, At)
        x = torch.as_tensor(_x(a.shape[0], 6))
        N = formats.negate_operator(At)
        assert isinstance(N, pell.PellMatrix) and N.enc == At.enc
        torch.testing.assert_close(N.matvec(x), -At.matvec(x), rtol=0, atol=0)
        _same(jformats.negate_operator(Aj), N)


def test_save_load_roundtrip_and_jax_files(tmp_path, encoder):
    n = 2048
    band = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
    scat = _csr("banded")[0]
    p = np.random.default_rng(8).permutation(n)
    cases = {
        "dia": dict(a=band, prefer="dia"),
        "ell": dict(a=band, prefer="ell"),
        "dense": dict(a=band, prefer="dense"),
        "pell": dict(a=scat, prefer="pell"),
        "routed": dict(a=sp.csr_matrix(band[p][:, p]), max_windows=1, sw=1024),
    }
    x = _x(n, 9)
    for name, kw in cases.items():
        a = kw.pop("a")
        At, rt = formats.make_operator(a, device="cpu", **kw)
        Aj, rj = jformats.make_operator(a, **kw)
        for writer, (A, route) in (("torch", (At, rt)), ("jax", (Aj, rj))):
            path = str(tmp_path / f"{name}_{writer}.npz")
            (formats.save_operator if writer == "torch" else jformats.save_operator)(
                path, A, route)
            B, route2 = formats.load_operator_npz(path, device="cpu")
            assert type(B) is type(At), (name, writer)
            assert (route2.format, route2.nnz, route2.notes) == (rt.format, rt.nnz, rt.notes)
            if rt.perm is None:
                assert route2.perm is None
            else:
                np.testing.assert_array_equal(route2.perm, rt.perm)
            xt = torch.as_tensor(x, dtype=B.dtype)
            torch.testing.assert_close(B.matvec(xt), At.matvec(xt), rtol=0, atol=0)
        if name == "pell":
            # and the JAX package reads the port's file
            Bj, _ = jformats.load_operator_npz(str(tmp_path / "pell_torch.npz"))
            _same(Bj, At)


def _empty_groups():
    """Empty rows and whole empty 128-row groups, and one group whose row
    700 touches all 16 chunks (16 units: the group fills K = 16)."""
    n = 2048
    a = sp.lil_matrix((n, n))
    for i, j, v in ((0, 0, 1.0), (299, 299, 2.0), (599, 5, 3.0), (1900, 1901, -1.0)):
        a[i, j] = v
    for c in range(16):
        a[700, 128 * c + 3] = 1.0 + c
    return sp.csr_matrix(a)


def _unit_counts(a, tile):
    """Per 128-row group, the unit encoder's unit count from the CSR alone:
    a unit is a (chunk, layer) pair, so a group holds, for every chunk its
    rows touch, as many units as one of its rows has entries there."""
    a = sp.csr_matrix(a)
    assert (a.data != 0).all()
    n = a.shape[0]
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    nch = -(-n // pell.LANES)
    pairs, per_row = np.unique(rows.astype(np.int64) * nch + a.indices // pell.LANES,
                               return_counts=True)
    gkey = pairs // nch // pell.LANES * nch + pairs % nch  # (group, chunk)
    groups_chunks, inv = np.unique(gkey, return_inverse=True)
    layers = np.zeros(len(groups_chunks), np.int64)
    np.maximum.at(layers, inv, per_row)
    ntiles = -(-n // tile)
    out = np.zeros(ntiles * (tile // pell.LANES), np.int64)
    np.add.at(out, groups_chunks // nch, layers)
    return out.reshape(ntiles, tile // pell.LANES)


def _operator(path, enc, a, kw, tmp_path):
    if path in ("numpy", "native"):
        return pell.PellMatrix.from_scipy(a, encoding=enc, device="cpu",
                                          native=path == "native", **kw)
    if path == "jax_file":
        J = jpell.PellMatrix.from_scipy(a, encoding=enc, device=False, native=False, **kw)
        jformats.save_operator(str(tmp_path / f"{enc}.npz"), J)
        return formats.load_operator_npz(str(tmp_path / f"{enc}.npz"), device="cpu")[0]
    M = pell.PellMatrix.from_scipy(a, encoding=enc, device="cpu", native=False, **kw)
    return formats.negate_operator(M) if path == "negate" else M.to("cpu")


def _prefix_step(A, x, v_prev, d, sb):
    """The step over each group's first ``slot_count`` slots alone: what
    K4 and K5 read (entries past the count are masked, their columns never
    used)."""
    nt, K, T = A.ntiles, A.k_slots, A.tile
    keep = torch.arange(K)[None, :, None] < A.slot_count.repeat_interleave(
        pell.LANES, dim=1)[:, None, :]
    cols = pell._columns(A).clamp(0, A.n_x - 1)
    acc = torch.where(keep, A.vals.reshape(nt, K, T) * x[cols], 0.0).sum(dim=1).reshape(-1)
    return acc - d * x[: A.n_pad] - sb * v_prev[: A.n_pad]


# every pattern in every encoding that takes it: the grouped encoders refuse
# wide_cluster (one row over 10 consecutive chunks, more than a slot-tile's
# windows cover)
SLOT_CASES = [(name, enc) for name in sorted(PATTERNS) + ["empty_groups"]
              for enc in ("unit", "grouped", "grouped4")
              if enc == "unit" or name != "wide_cluster"]


@pytest.mark.parametrize("path", ["numpy", "native", "jax_file", "negate", "to"])
@pytest.mark.parametrize("name,enc", SLOT_CASES)
def test_slot_count_is_the_unit_count(name, enc, path, tmp_path):
    # the property that lets K4 and K5 skip the padding slots exactly
    a, kw = _csr(name) if name in PATTERNS else (_empty_groups(), dict(tile=512))
    M = _operator(path, enc, a, kw, tmp_path)
    assert M.enc == enc and M.slot_count.dtype == torch.int32
    if enc == "unit":
        want = _unit_counts(a, M.tile)
        np.testing.assert_array_equal(M.slot_count.numpy(), want)
        if name == "empty_groups":
            assert (want == 0).any() and want.max() == M.k_slots == 16
    B = M.tile // pell.LANES
    occupied = M.vals.reshape(M.ntiles, M.k_slots, B, pell.LANES).abs().amax(dim=3)
    past = torch.arange(M.k_slots)[None, :, None] >= M.slot_count[:, None, :]
    assert not bool(occupied[past].any())
    # the prefix alone gives the step: scramble every index entry past the
    # count (lane and sub) and step over the prefix, f64
    rng = np.random.default_rng(14)
    M64 = dataclasses.replace(M, vals=M.vals.to(torch.float64))
    code = M64.lidx.clone().reshape(M.ntiles, M.k_slots, B, pell.LANES)
    top = 1 << (10 if enc != "unit" else 7)
    noise = torch.as_tensor(rng.integers(0, top, code.shape)).to(code.dtype)
    code[past[..., None].expand_as(code)] = noise[past[..., None].expand_as(code)]
    scrambled = dataclasses.replace(M64, lidx=code.reshape(M64.lidx.shape))
    x = torch.as_tensor(_x(M.n_x, 15))
    vp = torch.as_tensor(_x(M.n_x, 16))
    ref = pell.pell_step_ref(M64, x, vp, 0.7, -0.3)[: M.n_pad]
    got = _prefix_step(scrambled, x, vp, 0.7, -0.3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * float(ref.abs().max()))


@pytest.mark.parametrize("enc", ["unit", "grouped", "grouped4"])
@pytest.mark.parametrize("name", ["clusters", "empty_groups"])
def test_step_bytes_count_the_occupied_prefix(name, enc):
    # the bound's numerator, counted by hand per 128-row group
    a, kw = _csr(name) if name in PATTERNS else (_empty_groups(), dict(tile=512))
    M = pell.PellMatrix.from_scipy(a, encoding=enc, device="cpu", **kw)
    assert M.enc == enc
    B = M.tile // pell.LANES
    vals = M.vals.numpy().reshape(M.ntiles, M.k_slots, B, pell.LANES)
    idx_item = 1 if enc == "unit" else 2
    need = M.span_row.numel() * 4 + (M.n_x + 2 * M.n_pad) * 8
    for t in range(M.ntiles):
        for b in range(B):
            used = [u for u in range(M.k_slots) if vals[t, u, b].any()]
            cnt = used[-1] + 1 if used else 0
            bases = cnt if enc == "unit" else -(-cnt // pell.SLOTS) * pell.GROUPED_GEOM[enc][0]
            need += cnt * pell.LANES * (8 + idx_item) + bases * 4 + 4
    full = sum(t.numel() * t.element_size() for t in (M.vals, M.lidx, M.cbase, M.span_row))
    full += (M.n_x + 2 * M.n_pad) * 8
    assert pell.pell_step_bytes(M) == (need, full)
    assert need < full


def test_slot_count_survives_a_dtype_replace():
    a, kw = _csr("banded")
    M = pell.PellMatrix.from_scipy(a.astype(np.float32), encoding="unit", device="cpu", **kw)
    M64 = dataclasses.replace(M, vals=M.vals.to(torch.float64))
    assert M64.slot_count is M.slot_count
    torch.testing.assert_close(M64.slot_count, pell.pell_slot_counts(
        M64.vals, M64.ntiles, M64.k_slots, M64.tile), rtol=0, atol=0)
    x = torch.as_tensor(_x(a.shape[0], 11))
    np.testing.assert_allclose(M64.matvec(x).numpy(), a.astype(np.float32).astype(np.float64) @
                               x.numpy(), rtol=1e-12, atol=1e-12)
