"""The unit PELL encoding built on the operator's device.

``encode_for_route`` computes what ``PellMatrix.encode`` computes for the
unit encoding (the window plan, the unit plan, the planes) bit for bit,
as torch ops over every tile and entry at once, on the device that holds
the CSR arrays: the route copies them to the card once and encodes there
instead of on the host.  The same code runs on CPU tensors.

One sort carries the plan.  Inside a row tile the scratch-relative chunk
``ch`` of an entry is an increasing function of its chunk ``col // 128``
(the greedy windows start in increasing order and each covers its chunks
at offsets below ``sw / 128``), so equal ``ch`` are equal chunks and
``(ch, layer)`` sorts as ``(chunk, layer)``.  Hence one ``torch.unique``
of the entries' (128-row block, chunk, layer) keys gives each entry its
unit ordinal, each block its unit count (K), and, through the keys of
layer 0, each block's distinct chunks; a second, small one gives each
tile's distinct chunks, from which the window plan follows
(``need`` included: it depends on a tile's least and largest chunk
only).  The greedy covers walk every tile at once, one ``searchsorted``
a window.

Under ``encoding="auto"`` the host encoder also plans both grouped
geometries and keeps the cheapest by ``ops.pell._ENC_SLOT_COST``.
``grouped_bounds`` gives a lower bound on each geometry's K from the unit
plan: a grouped slot-tile holds at most 8 units of at most one entry a
row, and covers its chunks with ``nw`` windows of spread ``sp``, so a
128-row block needs at least ceil(max row nnz / 8) slot-tiles and at
least ceil(M_b / nw), M_b the least number of spread-``sp`` windows that
cover the block's distinct chunks (the greedy cover).  When every
geometry's cost at its bound is no less than the unit K, "auto" picks
unit whatever the grouped plans would give, and the card encodes;
otherwise the route encodes on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.pell import (
    _ENC_SLOT_COST, ENCODED, ENCODED_ON, GROUPED_GEOM, LANES, SLOTS, SW_CANDIDATES, SW_MAX,
    SW_MULTI, PellMatrix, PellPlanes)


@dataclasses.dataclass
class UnitPlan:
    """The unit plan of a CSR matrix on ``device`` (see ``plan_unit``):
    the window plan, and per distinct (block, chunk, layer) key its block
    and scratch-relative chunk, with the per-entry unit ordinal."""

    n: int
    tile: int
    sw: int
    k_slots: int
    span_row: torch.Tensor    # (ntiles, n_win) int32, padded with the last start
    n_win_of: torch.Tensor    # (ntiles,) windows per tile
    row: torch.Tensor         # (nnz,) int32 row of each entry
    lane: torch.Tensor        # (nnz,) int8 column % 128 of each entry
    uord: torch.Tensor        # (nnz,) int64 unit ordinal of each entry in its block
    ublock: torch.Tensor      # (U,) block of each unit
    uch: torch.Tensor         # (U,) scratch-relative chunk of each unit
    ubstart: torch.Tensor     # (nblocks + 1,) first unit of each block
    pair_block: torch.Tensor  # (P,) block of each distinct (block, chunk)
    pair_ch: torch.Tensor     # (P,) its scratch-relative chunk, ascending in a block
    max_row_nnz: int


def _greedy(keys, span, lo, hi, width, rounds, align=1, cap=None, record=False):
    """Greedy fixed-width covers of every segment at once.  Segment j holds
    the ascending values ``keys[lo[j]:hi[j]] - j * span``; a window starts
    at the first value not yet covered, rounded down to a multiple of
    ``align`` and clamped to ``cap``, and covers the values below its start
    plus ``width``.  Walks at most ``rounds`` windows a segment.  Returns
    (windows a segment, clipped at ``rounds``; the starts, (segments,
    rounds), when ``record``; the segments still uncovered)."""
    dev = keys.device
    i = lo.clone()
    count = torch.zeros(len(lo), dtype=torch.int64, device=dev)
    starts = torch.zeros((len(lo), rounds), dtype=torch.int64, device=dev) if record else None
    live = torch.nonzero(i < hi).squeeze(1)
    for r in range(rounds):
        if not live.numel():
            break
        s = (keys[i[live]] - live * span) // align * align
        if cap is not None:
            s = torch.clamp(s, max=cap)
        count[live] += 1
        if record:
            starts[live, r] = s
        i[live] = torch.searchsorted(keys, live * span + s + width)
        live = live[i[live] < hi[live]]
    return count, starts, live


def _put(array: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to a card through pinned memory, which the
    caching host allocator keeps for the next route (a 386 MB array takes
    0.02 s against 0.065 s from pageable memory on an H100's host)."""
    t = torch.from_numpy(array)
    if dev.type == "cuda" and torch.cuda.is_available():  # else torch's own error below
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _csr(a):
    """``a`` as CSR with sorted indices, as ``PellMatrix.encode`` reads it;
    a CSR input itself, so that the route's matrix, whose indices are
    known sorted, is not checked again (a pass over every entry)."""
    import scipy.sparse as sp

    csr = a if sp.issparse(a) and a.format == "csr" else sp.csr_matrix(a)
    csr.sort_indices()
    return csr


def plan_unit(csr, device, tile: int = 1024, sw: Optional[int] = None,
              max_windows: int = 16) -> UnitPlan:
    """The window plan and the unit plan of ``csr`` (a CSR matrix with
    entries and sorted indices) on ``device``, after one copy of its index
    arrays there.  Raises ``PellMatrix.encode``'s ``ValueError`` where a
    tile needs more than ``max_windows`` windows."""
    n, nnz = csr.shape[0], int(csr.nnz)
    assert nnz and tile % LANES == 0
    dev = torch.device(device)
    ntiles = -(-n // tile)
    n_pad = ntiles * tile
    g_tot = n_pad // LANES
    B = tile // LANES
    nblocks = ntiles * B
    # every value searched for below (a chunk or a window's end) is under span
    span = g_tot + 512

    indptr = _put(np.ascontiguousarray(csr.indptr, np.int64), dev)
    indices = _put(np.ascontiguousarray(csr.indices, np.int32), dev)
    rowlen = indptr[1:] - indptr[:-1]
    row = torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=dev), rowlen,
                                  output_size=nnz)
    chunk = indices // LANES
    lane = (indices % LANES).to(torch.int8)
    del indices

    # layer: the entry's rank in its run of equal chunks in its row
    brk = torch.ones(nnz, dtype=torch.bool, device=dev)
    torch.ne(chunk[1:], chunk[:-1], out=brk[1:])
    brk[indptr[:-1][rowlen > 0]] = True
    run = torch.cumsum(brk, 0, dtype=torch.int32)
    run -= 1
    layer = torch.arange(nnz, dtype=torch.int32, device=dev)
    layer -= torch.nonzero(brk).squeeze(1).to(torch.int32)[run]  # the run's first entry
    del brk, run
    s_l = int(layer.max()) + 1
    key = ((row // LANES).long() * g_tot + chunk) * s_l + layer
    del chunk, layer
    ukey, inv = torch.unique(key, sorted=True, return_inverse=True)
    del key
    ublock = ukey // (g_tot * s_l)
    ubstart = torch.searchsorted(ublock, torch.arange(nblocks + 1, device=dev))
    u_max = int((ubstart[1:] - ubstart[:-1]).max())
    uord = inv - ubstart[(row // LANES).long()]
    del inv
    ucg = ukey // s_l % g_tot
    pair = ukey[ukey % s_l == 0] // s_l  # distinct (block, chunk), ascending
    del ukey
    pair_block, pair_cg = pair // g_tot, pair % g_tot

    # each tile's distinct chunks, ascending; an empty tile gets its first row's
    t_ar = torch.arange(ntiles, device=dev)
    tile_nnz = indptr[torch.clamp((t_ar + 1) * tile, max=n)] - indptr[t_ar * tile]
    empty = t_ar[tile_nnz == 0]
    tkey = torch.unique(torch.cat([pair_block // B * span + pair_cg,
                                   empty * span + empty * tile // LANES]))
    lens = torch.bincount(tkey // span, minlength=ntiles)
    hi = torch.cumsum(lens, 0)
    lo = hi - lens
    first, last = tkey[lo] - t_ar * span, tkey[hi - 1] - t_ar * span
    need = int((last // 8 + 1 - first // 8).max()) * 1024

    if sw is None:
        if need <= SW_MAX:
            sw = need
        else:  # the cheapest candidate width, as PellMatrix.encode prices it
            best = None
            for cand in SW_CANDIDATES:
                counts, _, _ = _greedy(tkey, span, lo, hi, cand // LANES, max_windows + 1,
                                       align=8)
                if int(counts.max()) > max_windows:
                    continue
                cost = int(counts.sum()) * (cand + 2048)
                if best is None or cost < best[0]:
                    best = (cost, cand)
            sw = best[1] if best else SW_MULTI
    sw = max(((sw + 1023) // 1024) * 1024, 1024)
    sw = min(sw, max(((n_pad + 1023) // 1024) * 1024, 1024))
    sr = sw // LANES
    g_x = max(g_tot, sr)
    n_win_of, starts, over = _greedy(tkey, span, lo, hi, sr, max_windows, align=8,
                                     cap=g_x - sr, record=True)
    if over.numel():  # the first such tile's whole cover, for the host's message
        t = int(over.min())
        only = hi.clone()
        only[t] = lo[t]
        needs = _greedy(tkey, span, only, hi, sr, int(hi[t] - lo[t]), align=8, cap=g_x - sr)[0]
        raise ValueError(
            f"PELL window overflow: row tile {t} needs {int(needs[t])}"
            f" windows of {sw} columns (> max_windows={max_windows});"
            " RCM-reorder the matrix, raise sw, or raise max_windows"
        )
    W = int(n_win_of.max())
    starts = starts[:, :W]
    real = torch.arange(W, device=dev)[None, :] < n_win_of[:, None]
    span_row = torch.where(real, starts, starts.gather(1, (n_win_of - 1)[:, None]))
    # window lookup: last start <= chunk among the tile's own windows
    wkey = (t_ar[:, None] * span + span_row)[real]
    woff = torch.cumsum(n_win_of, 0) - n_win_of

    def rel(tiles, cg):
        g = torch.searchsorted(wkey, tiles * span + cg, right=True) - 1
        return (g - woff[tiles]) * sr + cg - (wkey[g] - tiles * span)

    return UnitPlan(
        n=n, tile=tile, sw=sw, k_slots=SLOTS * (-(-u_max // SLOTS)),
        span_row=span_row.to(torch.int32), n_win_of=n_win_of, row=row, lane=lane, uord=uord,
        ublock=ublock, uch=rel(ublock // B, ucg), ubstart=ubstart,
        pair_block=pair_block, pair_ch=rel(pair_block // B, pair_cg),
        max_row_nnz=int(rowlen.max()))


def grouped_bounds(plan: UnitPlan) -> Dict[str, int]:
    """A lower bound on each grouped geometry's K (module docstring).  The
    greedy covers stop at as many windows a block as settle the pick
    against the unit K (a cover cut short counts no more windows than the
    whole one)."""
    rounds = max(nw * math.ceil(plan.k_slots / (SLOTS * _ENC_SLOT_COST[g]))
                 for g, (nw, _) in GROUPED_GEOM.items())
    nblocks = len(plan.ubstart) - 1
    span = int(plan.n_win_of.max()) * (plan.sw // LANES) + SLOTS + 1
    keys = plan.pair_block * span + plan.pair_ch
    lens = torch.bincount(plan.pair_block, minlength=nblocks)
    hi = torch.cumsum(lens, 0)
    lo = hi - lens
    row_tiles = -(-plan.max_row_nnz // SLOTS)
    out = {}
    for g, (nw, sp) in GROUPED_GEOM.items():
        m = int(_greedy(keys, span, lo, hi, sp, rounds)[0].max())
        out[g] = SLOTS * max(-(-m // nw), row_tiles)
    return out


def unit_is_certain(plan: UnitPlan, bounds: Optional[Dict[str, int]] = None) -> bool:
    """True when ``_pick_encoding("auto", ...)`` picks unit whatever the
    grouped plans give: each geometry's cost at its lower bound
    (``bounds``, by default ``grouped_bounds(plan)``) is no less than the
    unit K (the pick needs a strictly lower cost)."""
    bounds = grouped_bounds(plan) if bounds is None else bounds
    return all(_ENC_SLOT_COST[g] * bounds[g] >= _ENC_SLOT_COST["unit"] * plan.k_slots
               for g in bounds)


def emit_unit(csr, plan: UnitPlan) -> PellPlanes:
    """The unit planes of ``plan`` on its device (``csr``, the planned
    matrix, gives the values, copied there once), synchronised; counts
    ``ENCODED["unit"]``."""
    dev = plan.row.device
    n, tile, K = plan.n, plan.tile, plan.k_slots
    ntiles = plan.span_row.shape[0]
    B = tile // LANES
    np_dtype = np.float64 if csr.data.dtype == np.float64 else np.float32
    data = _put(np.ascontiguousarray(csr.data, np_dtype), dev)
    at = (plan.row // tile).long() * K + plan.uord
    at *= tile
    at += plan.row % tile
    vals = torch.zeros(ntiles * K * tile, dtype=data.dtype, device=dev)
    vals[at] = data
    lidx = torch.zeros(ntiles * K * tile, dtype=torch.int8, device=dev)
    lidx[at] = plan.lane
    del at, data
    cbase = torch.zeros((8 * (-(-ntiles // 8)), B * K), dtype=torch.int32, device=dev)
    ub = plan.ublock
    cbase.view(-1)[ub * K + torch.arange(len(ub), device=dev) - plan.ubstart[ub]] = \
        plan.uch.to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ENCODED["unit"] += 1
    return PellPlanes(vals=vals.view(ntiles * K, tile), lidx=lidx.view(ntiles * K, tile),
                      cbase=cbase, span_row=plan.span_row, n=n, tile=tile, k_slots=K,
                      sw=plan.sw, nnz_count=int(csr.nnz), n_win=plan.span_row.shape[1],
                      enc="unit", encoder="card")


def encode_for_route(a, device, tile: int = 1024, sw: Optional[int] = None,
                     max_windows: int = 16, encoding: str = "auto",
                     on=None) -> PellPlanes:
    """``PellMatrix.encode(a, tile, sw, max_windows, encoding)`` for the
    route, counted in ``ENCODED_ON``: built on ``on`` (by default
    ``device`` where it is a CUDA device, else nowhere; tests pass
    "cpu") when ``a`` has entries and ``encoding`` is "unit", or "auto"
    certain to pick unit; else on the host.  An "auto" request the bound
    cannot settle pays the plan (its index copy, sort and bound) before
    the host encodes.  Spans: ``route.encode.plan`` around the plan and
    its bound, ``route.encode.host`` around the host encode (its args the
    encoding asked for, and the unit K and grouped bounds of a plan made
    before it: a span's args are fixed when it opens)."""
    from ca_lanczos_tpu_torch.utils.spans import span  # utils imports ops

    if on is None and torch.device(device).type == "cuda":
        on = device
    planned = ""
    if on is not None and encoding in ("unit", "auto") and a.nnz:
        csr = _csr(a)
        with span("route.encode.plan", encoding):
            plan = plan_unit(csr, on, tile=tile, sw=sw, max_windows=max_windows)
            bounds = grouped_bounds(plan) if encoding == "auto" else None
        if bounds is None or unit_is_certain(plan, bounds):
            ENCODED_ON["card"] += 1
            return emit_unit(csr, plan)
        planned = f" unit K={plan.k_slots} bounds " + " ".join(
            f"{g}={k}" for g, k in bounds.items())
        del plan
    with span("route.encode.host", encoding + planned):
        planes = PellMatrix.encode(a, tile=tile, encoding=encoding, max_windows=max_windows,
                                   sw=sw)
    ENCODED_ON["host"] += 1
    return planes
