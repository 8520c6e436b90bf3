"""PELL, pooled-chunk windowed ELL: the general-sparsity operator format.

Counterpart of ``ca_lanczos_tpu/ops/pell.py``.  The planes, the statics and
the encoders are the JAX package's, copied (``PellMatrix.encode`` and the
grouped encoder below are verbatim apart from where the planes land: host
arrays, which ``PellPlanes.to`` or ``from_scipy`` copy to a device), so
both packages encode a matrix to the same bits.  The layout, in brief:

* rows live on lanes: each 128-row group packs consecutive rows; ELL slots
  stack in slot-tiles of 8;
* a column splits as (chunk, lane) = (col // 128, col % 128);
* per row tile of ``tile`` rows, ``n_win`` x-span windows of ``sw``
  elements start at ``span_row[t, w]`` (in 128-element chunks); a
  scratch-relative chunk ``scr`` names window ``scr // (sw/128)`` and
  chunk ``span_row[t, w] + scr % (sw/128)``;
* UNIT encoding (kernel K4): slot u of group b is bound to one chunk,
  ``cbase[t, b*K + u]`` (scratch-relative), and ``lidx`` (int8) holds the
  lane of each element;
* GROUPED encodings (kernel K5, ``GROUPED_GEOM``): every element carries
  an int16 ``sub << 7 | lane``; the ``sub`` that places an element is
  stored at its SOURCE lane (``idx[j, b*128 + lane] >> 7``), and
  ``cbase[t, (b*KT + kt)*NW + sub // SP] + sub % SP`` is its
  scratch-relative chunk.

``to_dense`` is the decoding spec; ``pell_step_ref`` is the same decoding
vectorised in PyTorch and is the plain version of the kernels in
``csrc/pell.cu`` (wrappers in ``ops/cuda_pell``): one step
``y = A x - d x - sb v_prev`` on vectors zero-padded to ``n_x``.
``pell_apply`` and ``matrix_powers_pell`` take flat ``(n,)`` vectors and
pad internally; on CPU tensors they run the plain version, on CUDA
tensors the kernels.

The TPU kernels' x-span staging (double-buffered window DMA into VMEM,
the rolled span table, the 8-row SMEM blocking of ``cbase``) is not part
of this format's contract: the CUDA kernels gather x through L2 and
decode ``span_row``/``cbase`` themselves.  ``slot_count`` is the port's
own addition (the planes stay the JAX package's bits): K4 and K5 stop
each 128-row group at its last occupied slot.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

LANES = 128
SLOTS = 8  # slot-tile depth


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# one count per ``PellMatrix.encode`` call (and per card encode,
# ``ops.pell_card``), by the encoding it chose
ENCODED = {"unit": 0, "grouped": 0, "grouped4": 0}
# one count per PELL encode of ``ops.formats.make_operator``'s route, by
# where it ran (``ops.pell_card.encode_for_route``)
ENCODED_ON = {"card": 0, "host": 0}
# summed over the route's PellMatrices: the stored values, and the plane
# entries K4 and K5 walk (each 128-row group's ``slot_count`` slots of
# 128 lanes); one host read a route
SLOT_FILL = {"nnz": 0, "walked": 0}

# The window width's search (``PellMatrix.encode``'s ``sw``): one window
# up to SW_MAX elements, else the cheapest of the candidates.
SW_MAX, SW_MULTI = 65536, 16384
SW_CANDIDATES = (1024, 2048, 4096, 8192, SW_MULTI, 32768)


@dataclasses.dataclass(frozen=True)
class PellPlanes:
    """A PELL encoding short of a PellMatrix: the planes and statics that
    ``PellMatrix.encode`` computes, and which encoder ran: numpy arrays on
    the host (``"native"`` or ``"numpy"``), or tensors on the device that
    ``ops.pell_card.encode_for_route`` built them on (``"card"``).  ``to``
    puts them on a device as a PellMatrix.

    The encode stops here, short of a PellMatrix, so that the copy can be
    timed apart from it without moving work to the host.  A PellMatrix
    derives ``slot_count`` from its planes where they lie, in a pass over
    every slot (400 MB of values at 4M rows and 24 slots a row): slow on
    the host, a few milliseconds on the card."""

    vals: np.ndarray
    lidx: np.ndarray
    cbase: np.ndarray
    span_row: np.ndarray
    n: int
    tile: int
    k_slots: int
    sw: int
    nnz_count: int
    n_win: int
    enc: str
    encoder: str

    def to(self, device) -> "PellMatrix":
        def put(a):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(device)

        return PellMatrix(vals=put(self.vals), lidx=put(self.lidx), cbase=put(self.cbase),
                          span_row=put(self.span_row), n=self.n, tile=self.tile,
                          k_slots=self.k_slots, sw=self.sw, nnz_count=self.nnz_count,
                          n_win=self.n_win, enc=self.enc)


@dataclasses.dataclass(frozen=True)
class PellMatrix:
    """Pooled-chunk windowed ELL operator (see module docstring).

    vals / lidx : (ntiles*K, tile) slot-major, rows-on-lanes planes;
        ``lidx`` is int8 lanes (unit) or int16 ``sub<<7 | lane`` (grouped).
    cbase : (ntiles_pad8, B*K) int32 unit chunk bindings, or
        (ntiles_pad8, B*KT*NW) int32 grouped window bases; the row count is
        padded to a multiple of 8 as in the JAX package.
    span_row : (ntiles, n_win) int32 window starts in 128-element chunks.
    slot_count : (ntiles, tile/128) int32, per 128-row group one plus the
        index of its last slot holding a nonzero value (0 for an empty
        group): K4 and K5 walk only the slots below it.  Derived from ``vals``
        (:func:`pell_slot_counts`) when not given; ``to`` and
        ``dataclasses.replace`` carry it.  Over-counting is safe (the
        extra slots are zeros); under-counting drops nonzeros, so a
        ``replace`` that changes which values are nonzero must pass
        ``slot_count=None`` to have it derived again.
    """

    vals: torch.Tensor
    lidx: torch.Tensor
    cbase: torch.Tensor
    span_row: torch.Tensor
    n: int
    tile: int
    k_slots: int
    sw: int
    nnz_count: int
    n_win: int = 1
    enc: str = "unit"
    slot_count: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.slot_count is None:
            object.__setattr__(self, "slot_count", pell_slot_counts(
                self.vals, self.span_row.shape[0], self.k_slots, self.tile))

    @property
    def ntiles(self) -> int:
        return self.span_row.shape[0]

    @property
    def n_pad(self) -> int:
        return self.ntiles * self.tile

    @property
    def n_x(self) -> int:
        """x-buffer length: n_pad, extended so the widest span fits."""
        return max(self.n_pad, self.sw)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        return self.nnz_count

    def to(self, device) -> "PellMatrix":
        return dataclasses.replace(
            self, vals=self.vals.to(device), lidx=self.lidx.to(device),
            cbase=self.cbase.to(device), span_row=self.span_row.to(device),
            slot_count=self.slot_count.to(device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for x (n,) or (n, m): one step of the kernel per column
        (as the JAX package does); a complex x applies to its real and
        imaginary parts."""
        if x.is_complex():
            return torch.complex(self.matvec(x.real.contiguous()),
                                 self.matvec(x.imag.contiguous()))
        if x.ndim == 1:
            return pell_apply(self, x)
        return torch.stack([pell_apply(self, x[:, j].contiguous())
                            for j in range(x.shape[1])], dim=1)

    def to_dense(self) -> np.ndarray:
        """Dense reconstruction (host, testing only): the decoding spec."""
        T, K = self.tile, self.k_slots
        B = T // LANES
        vals = _np(self.vals).reshape(self.ntiles, K, T)
        lidx = _np(self.lidx).reshape(self.ntiles, K, T)
        span = _np(self.span_row).reshape(self.ntiles, self.n_win)
        sr = self.sw // LANES
        out = np.zeros((self.n, self.n), vals.dtype)
        if self.enc in GROUPED_GEOM:
            nw, sp = GROUPED_GEOM[self.enc]
            KT = K // SLOTS
            cb2 = _np(self.cbase)[: self.ntiles].reshape(
                self.ntiles, B, KT, nw
            )
            for t in range(self.ntiles):
                for s in range(K):
                    for c in range(T):
                        v = vals[t, s, c]
                        if v == 0.0:
                            continue
                        b, r = divmod(c, LANES)
                        lane = int(lidx[t, s, c]) & 127
                        sub = (int(lidx[t, s, b * LANES + lane]) >> 7) & 7
                        scr = cb2[t, b, s // SLOTS][sub // sp] + sub % sp
                        w, rel = divmod(int(scr), sr)
                        chunk = span[t, w] + rel
                        row = t * T + c
                        col = chunk * LANES + lane
                        if row < self.n and col < self.n:
                            out[row, col] += v
            return out
        cbase = _np(self.cbase)[: self.ntiles].reshape(self.ntiles, B, K)
        for t in range(self.ntiles):
            for u in range(K):
                for c in range(T):
                    v = vals[t, u, c]
                    if v == 0.0:
                        continue
                    b, r = divmod(c, LANES)
                    row = t * T + c
                    w, rel = divmod(cbase[t, b, u], sr)
                    chunk = span[t, w] + rel
                    col = chunk * LANES + lidx[t, u, c]
                    if row < self.n and col < self.n:
                        out[row, col] += v
        return out

    @staticmethod
    def from_scipy(
        a,
        tile: int = 1024,
        cmax: Optional[int] = None,  # accepted for API compat; unused
        sw: Optional[int] = None,
        max_windows: int = 16,
        device="cuda",  # torch device of the planes
        encoding: str = "unit",
        native: object = "auto",
    ) -> "PellMatrix":
        """``encode`` on the host, then the planes copied to ``device``."""
        return PellMatrix.encode(a, tile=tile, sw=sw, max_windows=max_windows,
                                 encoding=encoding, native=native).to(device)

    @staticmethod
    def encode(
        a,
        tile: int = 1024,
        sw: Optional[int] = None,
        max_windows: int = 16,
        encoding: str = "unit",
        native: object = "auto",
    ) -> "PellPlanes":
        """Encode a scipy.sparse matrix on the host (vectorized, O(nnz log
        nnz)); each call counts its chosen encoding in ``ENCODED``.

        sw: x-span WINDOW width in elements (multiple of 1024); default =
        smallest width covering every tile's column spread in ONE window
        when that fits in ``SW_MAX`` (64K), else ``SW_MULTI`` (16K) with as
        many windows per tile as the greedy chunk cover needs.  Scattered
        column clusters (periodic wrap, arrow patterns) therefore encode
        without RCM; only sparsity needing more than ``max_windows``
        windows of sw (i.e. > max_windows*sw bytes of x per tile resident
        in VMEM) is rejected.
        encoding: "unit", "grouped" (two spread-4 windows), "grouped4"
        (four spread-2 windows — multi-cluster tiles, GROUPED_GEOM), or
        "auto" (plan all, keep the lowest HBM traffic per SpMV — grouped
        moves 6 B/slot vs unit's 5, but usually needs fewer slots AND
        runs a cheaper inner loop; grouped4 pays ~15% extra mechanism
        and wins when 2-window packing inflates K, see module
        docstring).
        native: "auto" (use the C++ encoder when its library loads —
        ~40x the numpy path, OpenMP block-parallel; see
        native/pell_encode.cpp), True (require it), or False (numpy).
        Both paths emit identical plane LAYOUTS; slot assignments may
        differ (both valid — matvec-parity-tested).
        """
        import scipy.sparse as sp

        csr = sp.csr_matrix(a)
        csr.sort_indices()
        n = csr.shape[0]
        assert tile % LANES == 0
        ntiles = -(-n // tile)
        n_pad = ntiles * tile
        g_tot = n_pad // LANES
        B = tile // LANES

        indptr, indices, data = csr.indptr, csr.indices, csr.data
        dtype = np.float32 if data.dtype != np.float64 else data.dtype

        # Pass 1: per-tile greedy window cover of the touched chunks.
        need = 0
        for t in range(ntiles):
            lo_r, hi_r = t * tile, min((t + 1) * tile, n)
            seg = indices[indptr[lo_r] : indptr[hi_r]]
            cmin = int(seg.min()) if seg.size else lo_r
            cmax_col = int(seg.max()) if seg.size else lo_r
            need = max(need, cmax_col + 1 - ((cmin // 1024) * 1024))
        need = ((need + 1023) // 1024) * 1024

        tile_chunks = []
        for t in range(ntiles):
            lo_r, hi_r = t * tile, min((t + 1) * tile, n)
            seg = indices[indptr[lo_r] : indptr[hi_r]]
            tile_chunks.append(
                np.unique(seg // LANES).astype(np.int64) if seg.size
                else np.asarray([lo_r // LANES], np.int64)
            )

        if sw is None:
            if need <= SW_MAX:
                sw = need
            else:
                # Multi-window regime: choose the window width that
                # MINIMIZES the total span-DMA fetch (sum over tiles of
                # windows x sw) subject to max_windows.  The old fixed
                # SW_MULTI=16K width over-fetched ~8x on 216^3-scale
                # cluster sparsity (three ~1.5K-column clusters per
                # tile), making the span stream ~40% of kernel traffic
                # (round-5; see BENCHMARKS.md).
                best = None
                cands = SW_CANDIDATES
                flat = np.concatenate(tile_chunks)
                lens = np.asarray([len(ch) for ch in tile_chunks])
                hi = np.cumsum(lens)
                lo = hi - lens
                span = int(flat.max()) + 1 + max(cands) // LANES
                keys = np.repeat(np.arange(ntiles, dtype=np.int64) * span, lens) + flat

                def _greedy_counts(srq):
                    """Windows of srq chunks (1024-aligned starts) each tile
                    needs: the greedy cover (a window starts at the first
                    chunk not yet covered), walked for all tiles at once on
                    their chunks laid end to end, keyed tile * span + chunk."""
                    i = lo.copy()
                    cnt = np.zeros(ntiles, np.int64)
                    live = np.flatnonzero(i < hi)
                    while live.size:
                        start = (flat[i[live]] // 8) * 8
                        cnt[live] += 1
                        i[live] = np.searchsorted(keys, live * span + start + srq, side="left")
                        live = live[i[live] < hi[live]]
                    return cnt

                for cand in cands:
                    counts = _greedy_counts(cand // LANES)
                    tot, mx = int(counts.sum()), int(counts.max())
                    if mx > max_windows:
                        continue
                    # Each window costs its fetch plus a fixed DMA-start
                    # charge (~2K elements) so the optimizer doesn't
                    # fragment into many tiny windows for a marginal
                    # fetch saving.
                    cost = tot * (cand + 2048)
                    if best is None or cost < best[0]:
                        best = (cost, cand)
                sw = best[1] if best else SW_MULTI
        sw = max(((sw + 1023) // 1024) * 1024, 1024)
        sw = min(sw, max(((n_pad + 1023) // 1024) * 1024, 1024))
        sr = sw // LANES  # window width in 128-element rows (multiple of 8)
        g_x = max(g_tot, sr)
        win_lists = []
        for t in range(ntiles):
            chunks = tile_chunks[t]
            wins = []
            i = 0
            while i < len(chunks):
                start = (int(chunks[i]) // 8) * 8  # 1024-element alignment
                start = min(start, g_x - sr)  # keep the DMA inside the buffer
                wins.append(start)
                i = int(np.searchsorted(chunks, start + sr, side="left"))
            if len(wins) > max_windows:
                raise ValueError(
                    f"PELL window overflow: row tile {t} needs {len(wins)}"
                    f" windows of {sw} columns (> max_windows={max_windows});"
                    " RCM-reorder the matrix, raise sw, or raise max_windows"
                )
            win_lists.append(np.asarray(wins, np.int64))
        W = max(len(w) for w in win_lists)
        span_rows = np.zeros((ntiles, W), np.int64)
        for t, wins in enumerate(win_lists):
            span_rows[t, : len(wins)] = wins
            span_rows[t, len(wins) :] = wins[-1]  # harmless repeat DMA

        def _finish(vals, lidx, cbase, K, enc, encoder):
            ENCODED[enc] += 1
            return PellPlanes(
                vals=vals,
                lidx=lidx,
                cbase=cbase,
                span_row=span_rows.astype(np.int32),
                n=n,
                tile=tile,
                k_slots=K,
                sw=sw,
                nnz_count=int(csr.nnz),
                n_win=W,
                enc=enc,
                encoder=encoder,
            )

        # Native (C++) encoder: block-parallel O(nnz) planning, plane
        # scatter for the winning encoding only.
        from ca_lanczos_tpu_torch.ops import _pell_native as _pn

        if native is True and not _pn.available():
            # Explicit native=True with no loadable library would crash
            # deep inside plan_unit with lib=None (ADVICE r4) — fail at
            # the API boundary with the actionable message instead.
            raise RuntimeError(
                "native PELL encoder requested (native=True) but "
                "native/pell_encode.cpp could not be built or loaded — check "
                "g++/OpenMP availability, or pass native='auto' to fall "
                "back to the numpy encoder"
            )
        if encoding not in ("unit", "grouped", "grouped4", "auto"):
            raise ValueError(f"unknown PELL encoding {encoding!r}")
        if int(csr.nnz) and native in (True, "auto") and _pn.available():
            csr_c = _pn._Csr(indptr, indices, data, dtype)
            wins32 = np.ascontiguousarray(span_rows, np.int32)
            wcnt = np.asarray([len(w) for w in win_lists], np.int32)
            # the plans are independent: run them side by side (ctypes
            # releases the GIL; each is OpenMP-parallel inside).  This
            # shortens the host encode that every PELL route repeats, and
            # with it the swing of the route's seconds under a shared host
            tries = _grouped_tries(encoding)
            with ThreadPoolExecutor(1 + len(tries)) as pool:
                unit = pool.submit(_pn.plan_unit, csr_c, n, tile, sr, wins32, wcnt)
                grouped = {g: pool.submit(_pn.plan_grouped, csr_c, n, tile, sr, wins32, wcnt,
                                          nw=GROUPED_GEOM[g][0]) for g in tries}
                ch_u, uord_u, K_u = unit.result()
                plans = {g: f.result() for g, f in grouped.items()}
            plans = {g: p for g, p in plans.items() if p is not None}
            if encoding in GROUPED_GEOM and encoding not in plans:
                raise ValueError(
                    f"{encoding} PELL encoding failed; use encoding='unit'"
                )
            pick = _pick_encoding(encoding, K_u, {g: p[3] for g, p in plans.items()})
            if pick != "unit":
                gp = plans[pick]
                planes = _pn.emit_grouped(
                    csr_c, n, tile, gp[0], gp[1], gp[2], gp[3], dtype,
                    nw=GROUPED_GEOM[pick][0],
                )
                return _finish(*planes, pick, "native")
            planes = _pn.emit_unit(csr_c, n, tile, ch_u, uord_u, K_u, dtype)
            return _finish(*planes, "unit", "native")

        # Pass 2 (vectorized): unit assignment.  A UNIT is a (block,
        # chunk, layer) triple; layer j holds the (j+1)-th nonzero each
        # row has in that chunk, so every unit carries <=1 entry per lane
        # and one chunk binding.  Everything stays int32: this host's
        # int64 accumulate/gather paths are ~100x slower.
        nnz = int(csr.nnz)

        grouped = grouped_enc = None
        if nnz:
            for g in _grouped_tries(encoding):
                cand = _encode_grouped(
                    indptr, indices, data, n, tile, win_lists, sw, dtype,
                    geom=g,
                )
                if cand is not None and (
                    grouped is None or cand[3] < grouped[3]
                ):
                    grouped, grouped_enc = cand, g
                if grouped is not None and encoding != "auto":
                    break
        if encoding in ("grouped", "grouped4") and grouped is None:
            raise ValueError(
                f"{encoding} PELL encoding failed; use encoding='unit'"
            )

        def run_rank(brk, ar):
            """Per-element offset within runs delimited by brk (int32)."""
            ar = ar[: len(brk)]
            first = np.maximum.accumulate(np.where(brk, ar, np.int32(0)))
            return ar - first

        if nnz:
            rowcounts = np.diff(indptr).astype(np.int32)
            r_glob = np.repeat(np.arange(n, dtype=np.int32), rowcounts)
            idx32 = indices.astype(np.int32)
            # Scratch-relative binding: w*SR + (chunk - win_start_w), with
            # w the covering window (last start <= chunk; greedy cover
            # guarantees it reaches).  Tile entries are contiguous in CSR.
            chunk_g = idx32 // np.int32(LANES)
            ch = np.empty(nnz, np.int32)
            for t in range(ntiles):
                e0 = indptr[t * tile]
                e1 = indptr[min((t + 1) * tile, n)]
                wins = win_lists[t]
                cg = chunk_g[e0:e1]
                w = np.searchsorted(wins, cg, side="right") - 1
                ch[e0:e1] = (w * sr + (cg - wins[w])).astype(np.int32)
            ln = idx32 % LANES
            block = r_glob // LANES
            lane = r_glob % LANES

            # layer = occurrence index within each contiguous (row, chunk)
            # run (CSR is row- then col-sorted, so runs are contiguous).
            ar_nnz = np.arange(nnz, dtype=np.int32)
            brk = np.empty(nnz, bool)
            brk[0] = True
            np.not_equal(ch[1:], ch[:-1], out=brk[1:])
            brk[1:] |= r_glob[1:] != r_glob[:-1]
            layer = run_rank(brk, ar_nnz)

            # Sort entries by (block, chunk, layer): one int64 composite
            # argsort (fast here), then int32 gathers of the components.
            s_ch = int(ch.max()) + 1
            s_l = int(layer.max()) + 1
            ukey = (block.astype(np.int64) * s_ch + ch) * s_l + layer
            order = np.argsort(ukey, kind="stable").astype(np.int32)
            block_s, ch_s, layer_s = block[order], ch[order], layer[order]

            # Unit id per sorted entry; units are runs of equal key.
            ubrk = np.empty(nnz, bool)
            ubrk[0] = True
            np.not_equal(ch_s[1:], ch_s[:-1], out=ubrk[1:])
            ubrk[1:] |= (block_s[1:] != block_s[:-1]) | (layer_s[1:] != layer_s[:-1])
            uid_s = np.cumsum(ubrk, dtype=np.int32) - 1  # per sorted entry
            ublock = block_s[ubrk]
            uch = ch_s[ubrk]
            # per-block unit ordinal (units are block-sorted)
            ubrk2 = np.empty(len(ublock), bool)
            ubrk2[0] = True
            np.not_equal(ublock[1:], ublock[:-1], out=ubrk2[1:])
            uord = run_rank(ubrk2, ar_nnz)
            u_max = int(uord.max()) + 1
        else:
            u_max = 1

        K = SLOTS * (-(-u_max // SLOTS))
        pick = _pick_encoding(
            encoding, K, {grouped_enc: grouped[3]} if grouped else {}
        )
        ntiles_pad8 = 8 * (-(-ntiles // 8))
        if pick != "unit":
            vals, lidx, cbase, K = grouped
            enc = grouped_enc
        else:
            enc = "unit"
            vals = np.zeros((ntiles * K, tile), dtype)
            lidx = np.zeros((ntiles * K, tile), np.int8)
            cbase = np.zeros((ntiles_pad8, B * K), np.int32)
            if nnz:
                uord_s = uord[uid_s]  # per sorted entry
                t_s = block_s // B
                b_s = block_s % B
                rix = t_s * np.int32(K) + uord_s
                cix = b_s * np.int32(LANES) + lane[order]
                vals[rix, cix] = data[order]
                lidx[rix, cix] = ln[order]
                cbase[ublock // B, (ublock % B) * np.int32(K) + uord] = uch

        return _finish(vals, lidx, cbase, K, enc, "numpy")

    @staticmethod
    def from_dense(a: np.ndarray, **kw) -> "PellMatrix":
        import scipy.sparse as sp

        return PellMatrix.from_scipy(sp.csr_matrix(np.asarray(a)), **kw)


# Grouped-window geometries: nw windows of spread sp, nw*sp == 8 (the
# gather source is one (8, 128) tile either way).  "grouped" is the
# original two-spread-4 form; "grouped4" (round-5) covers up to four
# scattered chunk clusters — the 216^3-scale multi-window-tile case
# where three z-plane clusters per slot-tile made the 2-window packing
# inflate K2 past the unit encoding's price (VERDICT r4 item 5).  Any
# 2x4 cover is also a 4x2 cover (split each window), so grouped4 is
# strictly more general; it costs two extra dynamic slices per
# slot-tile, so "auto" prefers the 2-window form at equal K.
GROUPED_GEOM = {"grouped": (2, 4), "grouped4": (4, 2)}


def _cover_windows(chunks, nw: int, sp: int):
    """Greedy fixed-length interval cover: bases of ``nw`` spread-``sp``
    windows covering the chunk set, or None if more would be needed.
    Greedy (next window starts at the first uncovered chunk) is optimal
    for fixed-length covers.  Unused windows repeat the last base."""
    cs = sorted(set(chunks))
    bases = []
    i = 0
    while i < len(cs):
        if len(bases) == nw:
            return None
        b = cs[i]
        bases.append(b)
        while i < len(cs) and cs[i] - b < sp:
            i += 1
    if not bases:
        bases = [0]
    while len(bases) < nw:
        bases.append(bases[-1])
    return bases


def _cover2(chunks) -> bool:
    """True if the sorted chunk iterable fits two 4-row spread windows."""
    return _cover_windows(chunks, 2, 4) is not None


# Measured per-slot cost weights for the auto pricing (relative to the
# unit encoding's slot).  Hardware slot rates (exp/pell_grouped_bench,
# exp/pell_216_bench): grouped processes slots 24-31% faster than unit
# on every >=262k-row pattern (52 vs 68 Gslot/s at 216^3; 50 vs 60 at
# the 262k 27-pt), so the earlier HBM-bytes-only model (6 vs 5 B/slot)
# mispriced it — at 216^3 it picked unit (24.9 Gnnz/s) over grouped
# (37.9, +53%).  grouped4 pays ~4% over grouped for its two extra
# dynamic slices (measured -8%..+1%).
# (Those rates were measured on the TPU kernels.  The weights are kept as
# they are so that "auto" picks what the JAX package picks; they say
# nothing about K4/K5 on the card.)
_ENC_SLOT_COST = {"unit": 1.0, "grouped": 0.80, "grouped4": 0.84}


def _grouped_tries(encoding: str):
    """Grouped geometries to plan for an encoding request, cheapest
    mechanism first: auto plans every one (a 4-window K reduction can
    beat an already-winning 2-window plan)."""
    if encoding == "unit":
        return []
    if encoding in GROUPED_GEOM:
        return [encoding]
    return ["grouped", "grouped4"]  # auto


def _pick_encoding(encoding: str, K_u: int, grouped_Ks: dict) -> str:
    """Choose among unit and the successfully-planned grouped
    geometries.  Explicit requests win unconditionally; auto minimizes
    K x the measured per-slot cost (_ENC_SLOT_COST)."""
    if encoding in GROUPED_GEOM:
        return encoding  # caller has validated availability
    if encoding == "unit" or not grouped_Ks:
        return "unit"
    best, cost = "unit", _ENC_SLOT_COST["unit"] * K_u
    for g in ("grouped", "grouped4"):
        if g in grouped_Ks:
            c = _ENC_SLOT_COST[g] * grouped_Ks[g]
            if c < cost:
                best, cost = g, c
    return best


def _encode_grouped(indptr, indices, data, n, tile, win_lists, sw, dtype,
                    max_iter=64, max_units=512, geom: str = "grouped"):
    """Grouped (windowed, per-element) PELL encoding.

    geom: "grouped" = two spread-4 windows; "grouped4" = four spread-2
    windows (GROUPED_GEOM).  Returns (vals, idx16, cbase2, K2) or None
    when the constraints do not converge (caller falls back to the unit
    encoding).  See module docstring for the layout; the assignment is:

      1. cluster = per-block run of touched scratch chunks (gap >= 3
         splits), per-(row, cluster) rank, cluster-segmented unit ids;
      2. conflict bumping until every unit has <=1 entry per row and
         one chunk per source lane;
      3. per-block greedy packing of units into slot-tiles of 8 under
         the nw-window cover, recording the per-slot-tile window bases;
      4. plane emission: vals + ONE int16 plane with the lane (low 7
         bits, at the entry's OUT-row position) and the chunk-window
         offset (bits 7-9, at the entry's SOURCE-lane position):
         sub = w*sp + (chunk - base_w).
    """
    nw, sp = GROUPED_GEOM[geom]
    nnz = int(indptr[-1])
    sr = sw // LANES
    ntiles = len(win_lists)
    B = tile // LANES
    nblocks = ntiles * B

    rowcounts = np.diff(indptr).astype(np.int32)
    r_glob = np.repeat(np.arange(n, dtype=np.int32), rowcounts)
    idx32 = indices.astype(np.int32)
    chunk_g = idx32 // np.int32(LANES)
    ch = np.empty(nnz, np.int32)
    for t in range(ntiles):
        e0, e1 = indptr[t * tile], indptr[min((t + 1) * tile, n)]
        wins = win_lists[t]
        cg = chunk_g[e0:e1]
        w = np.searchsorted(wins, cg, side="right") - 1
        ch[e0:e1] = (w * sr + (cg - wins[w])).astype(np.int32)
    lane = idx32 % np.int32(LANES)
    block = r_glob // np.int32(LANES)
    row_l = r_glob % np.int32(LANES)
    ar = np.arange(nnz, dtype=np.int32)

    # -- 1. clusters and per-(row, cluster) ranks ------------------------
    S_ch = int(ch.max()) + 1
    pkey = block.astype(np.int64) * S_ch + ch
    order_p = np.argsort(pkey, kind="stable")
    pk_s = pkey[order_p]
    ubrk = np.empty(nnz, bool)
    ubrk[0] = True
    np.not_equal(pk_s[1:], pk_s[:-1], out=ubrk[1:])
    pb = block[order_p][ubrk]
    pc = ch[order_p][ubrk]
    cbrk = np.empty(len(pb), bool)
    cbrk[0] = True
    cbrk[1:] = (pb[1:] != pb[:-1]) | (pc[1:] - pc[:-1] >= 3)
    cid_of_pair = np.cumsum(cbrk, dtype=np.int32) - 1
    pair_of_sorted = np.cumsum(ubrk, dtype=np.int32) - 1
    cid = np.empty(nnz, np.int32)
    cid[order_p] = cid_of_pair[pair_of_sorted]
    ncl = int(cid_of_pair[-1]) + 1
    cl_block = pb[cbrk].astype(np.int64)

    # CSR order is row-major with ch ascending inside a row, so
    # (row, cid) runs are contiguous.
    brk = np.empty(nnz, bool)
    brk[0] = True
    brk[1:] = (r_glob[1:] != r_glob[:-1]) | (cid[1:] != cid[:-1])
    first = np.maximum.accumulate(np.where(brk, ar, np.int32(0)))
    rank = ar - first

    # -- 2. conflict resolution --------------------------------------------
    # Ranks collide when per-row patterns are not locally-shifted copies
    # (e.g. lattice-boundary rows with missing neighbors).  A few cheap
    # vectorized +1 bumps fix sparse collisions; anything left gets a
    # guaranteed-terminating sequential repair: each conflicted entry
    # walks up to the first rank in its (row-cluster) segment that is
    # free for its (lane -> chunk) binding and row.
    bb = np.empty(ncl, bool)
    bb[0] = True
    bb[1:] = cl_block[1:] != cl_block[:-1]

    def conflicts(rank):
        width = np.zeros(ncl, np.int32)
        np.maximum.at(width, cid, rank + np.int32(1))
        csum = np.cumsum(width, dtype=np.int64)
        base = csum - width
        blk_first = np.maximum.accumulate(np.where(bb, base, 0))
        base_in_blk = (base - blk_first).astype(np.int32)
        unit = base_in_blk[cid] + rank
        S_u = int(unit.max()) + 1
        if S_u > max_units:
            return None, None, S_u
        # A: same (block, unit, source lane) must share the chunk
        kA = (block.astype(np.int64) * S_u + unit) * LANES + lane
        oA = np.argsort(kA, kind="stable")
        kA_s = kA[oA]
        gbrk = np.empty(nnz, bool)
        gbrk[0] = True
        np.not_equal(kA_s[1:], kA_s[:-1], out=gbrk[1:])
        runstart = np.maximum.accumulate(np.where(gbrk, ar, np.int32(0)))
        conf = np.zeros(nnz, bool)
        conf[oA] = ch[oA] != ch[oA][runstart]
        # B: same (block, unit, row) — possible only after bumps
        kB = (block.astype(np.int64) * S_u + unit) * LANES + row_l
        oB = np.argsort(kB, kind="stable")
        kB_s = kB[oB]
        gbrkB = np.empty(nnz, bool)
        gbrkB[0] = True
        np.not_equal(kB_s[1:], kB_s[:-1], out=gbrkB[1:])
        conf[oB] |= ~gbrkB
        return conf, unit, S_u

    conf = None
    for _ in range(4):
        conf, unit, S_u = conflicts(rank)
        if conf is None:
            return None
        if not conf.any():
            break
        rank = rank + conf.astype(np.int32)
    if conf is not None and conf.any():
        # Sequential repair over the conflicted segments only.
        bad_cid = np.unique(cid[conf])
        in_bad = np.isin(cid, bad_cid)
        taken_lane = {}  # (cid, rank, lane) -> chunk
        taken_row = set()  # (cid, rank, row)
        keep = in_bad & ~conf
        for i in np.nonzero(keep)[0]:
            key = (int(cid[i]), int(rank[i]))
            taken_lane[key + (int(lane[i]),)] = int(ch[i])
            taken_row.add(key + (int(row_l[i]),))
        for i in np.nonzero(conf)[0]:
            ci, li, ri, hi_c = int(cid[i]), int(lane[i]), int(row_l[i]), int(ch[i])
            rk = int(rank[i])
            while True:
                kl = (ci, rk, li)
                kr = (ci, rk, ri)
                if kr not in taken_row and taken_lane.get(kl, hi_c) == hi_c:
                    taken_lane[kl] = hi_c
                    taken_row.add(kr)
                    rank[i] = rk
                    break
                rk += 1
                if rk > max_units:
                    return None
        conf, unit, S_u = conflicts(rank)
        if conf is None or conf.any():
            return None

    # -- 3. per-block tile packing under the 2-window cover --------------
    kU = (block.astype(np.int64) * S_u + unit) * S_ch + ch
    oU = np.argsort(kU, kind="stable")
    kU_s = kU[oU]
    tbrk = np.empty(nnz, bool)
    tbrk[0] = True
    np.not_equal(kU_s[1:], kU_s[:-1], out=tbrk[1:])
    tb = block[oU][tbrk]
    tu = unit[oU][tbrk]
    tc = ch[oU][tbrk]
    blk_starts = np.searchsorted(tb, np.arange(nblocks + 1))
    slot_map = np.full((nblocks, S_u), -1, np.int32)
    per_block_bases = []
    K2 = 0
    for bk in range(nblocks):
        lo, hi = blk_starts[bk], blk_starts[bk + 1]
        if lo == hi:
            per_block_bases.append([])
            continue
        units_u = tu[lo:hi]
        chs = tc[lo:hi]
        ub = np.empty(hi - lo, bool)
        ub[0] = True
        ub[1:] = units_u[1:] != units_u[:-1]
        ustarts = np.nonzero(ub)[0]
        uends = np.append(ustarts[1:], hi - lo)
        btiles = []
        cur_units, cur_chunks = [], []
        for k in range(len(ustarts)):
            u = int(units_u[ustarts[k]])
            cset = list(chs[ustarts[k] : uends[k]])
            if (len(cur_units) < SLOTS
                    and _cover_windows(cur_chunks + cset, nw, sp) is not None):
                cur_units.append(u)
                cur_chunks += cset
            else:
                if not cur_units or _cover_windows(cset, nw, sp) is None:
                    # A single unit whose own chunk spread exceeds the
                    # nw-window cover cannot be grouped at all — fall
                    # back to the unit encoding rather than emit an
                    # empty slot-tile.
                    return None
                btiles.append((cur_units, cur_chunks))
                cur_units, cur_chunks = [u], cset
        btiles.append((cur_units, cur_chunks))
        bases = []
        for s_t, (us, cks) in enumerate(btiles):
            bases.append(tuple(_cover_windows(cks, nw, sp)))
            for j, u in enumerate(us):
                slot_map[bk, u] = s_t * SLOTS + j
        per_block_bases.append(bases)
        K2 = max(K2, len(btiles) * SLOTS)
    if K2 == 0:
        return None
    KT2 = K2 // SLOTS

    # -- 4. plane emission -------------------------------------------------
    base_arr = np.zeros((nblocks, KT2, nw), np.int32)
    for bk, bases in enumerate(per_block_bases):
        for kt, bs in enumerate(bases):
            base_arr[bk, kt, :] = bs
    slot_e = slot_map[block, unit]
    assert (slot_e >= 0).all()
    kt_e = slot_e // SLOTS
    b_e = base_arr[block, kt_e, :]          # (nnz, nw)
    off_e = ch[:, None] - b_e               # (nnz, nw)
    valid = (off_e >= 0) & (off_e < sp)
    if not valid.any(axis=1).all():
        return None  # cover bookkeeping failure; fall back
    w_e = np.argmax(valid, axis=1).astype(np.int32)  # first covering window
    sub_e = w_e * np.int32(sp) + off_e[np.arange(nnz), w_e]
    if not ((sub_e >= 0) & (sub_e < 8)).all():
        return None
    t_e = block // B
    bl_e = block % B
    rix = t_e * np.int32(K2) + slot_e
    vals_p = np.zeros((ntiles * K2, tile), dtype)
    idx16 = np.zeros((ntiles * K2, tile), np.int16)
    cix_out = bl_e * np.int32(LANES) + row_l
    cix_src = bl_e * np.int32(LANES) + lane
    vals_p[rix, cix_out] = data
    idx16[rix, cix_out] |= lane.astype(np.int16)
    idx16[rix, cix_src] |= (sub_e.astype(np.int16) << 7)
    ntiles_pad8 = 8 * (-(-ntiles // 8))
    cbase2 = np.zeros((ntiles_pad8, B * KT2 * nw), np.int32)
    for bk, bases in enumerate(per_block_bases):
        t, b_l = divmod(bk, B)
        for kt, bs in enumerate(bases):
            for w in range(nw):
                cbase2[t, (b_l * KT2 + kt) * nw + w] = bs[w]
    return vals_p, idx16, cbase2, K2


# ---------------------------------------------------------------------------
# The plain PyTorch step (plain version of K4/K5) and the public applies.
# ---------------------------------------------------------------------------


def pell_slot_counts(vals: torch.Tensor, ntiles: int, K: int, tile: int) -> torch.Tensor:
    """(ntiles, tile/128) int32: per 128-row group, one plus the index of
    the last slot with a nonzero value, 0 for an empty group.  The
    encoders give a group's units the ordinals 0..u-1, so for the unit
    encoding this is the group's unit count and every slot at or past it
    is zero."""
    occupied = (vals.reshape(ntiles, K, tile // LANES, LANES) != 0).any(dim=3)
    ordinal = torch.arange(1, K + 1, dtype=torch.int32, device=vals.device)
    return (occupied * ordinal[None, :, None]).amax(dim=1).to(torch.int32).contiguous()


def pell_step_bytes(A: PellMatrix) -> Tuple[int, int]:
    """(bytes one step must move, bytes of the full planes + vectors),
    the bound's numerator.  The occupied prefix of each group's slots
    (taken from vals itself, so it counts what the function needs
    whichever kernel runs) of vals and lidx, with the cbase entries it
    uses (unit: one a slot; grouped: NW per used slot-tile of 8), plus the
    per-group counts and span_row.  Both add x (n_x) and v_prev read once,
    y (n_pad) written once."""
    item = A.vals.element_size()
    vectors = (A.n_x + 2 * A.n_pad) * item
    full = sum(t.numel() * t.element_size()
               for t in (A.vals, A.lidx, A.cbase, A.span_row)) + vectors
    counts = pell_slot_counts(A.vals, A.ntiles, A.k_slots, A.tile)
    slots = int(counts.sum())
    if A.enc in GROUPED_GEOM:
        bases = int(((counts + SLOTS - 1) // SLOTS).sum()) * GROUPED_GEOM[A.enc][0]
    else:
        bases = slots
    need = (slots * LANES * (item + A.lidx.element_size()) + (bases + counts.numel()) * 4
            + A.span_row.numel() * 4 + vectors)
    return need, full


def _columns(A: PellMatrix) -> torch.Tensor:
    """Column index of every plane entry, (ntiles, K, tile) int64, decoded
    as ``to_dense`` decodes (vectorised).  A window index past the last
    window (possible only for a zero padding entry) is clamped to it, so
    every index stays inside the ``n_x`` buffer, as in the kernels."""
    nt, K, T = A.ntiles, A.k_slots, A.tile
    B = T // LANES
    sr = A.sw // LANES
    dev = A.lidx.device
    code = A.lidx.reshape(nt, K, T).long()
    if A.enc in GROUPED_GEOM:
        nw, sp = GROUPED_GEOM[A.enc]
        KT = K // SLOTS
        lane = code & 127
        group = (torch.arange(T, device=dev) // LANES)[None, None, :]
        # ``sub`` sits at the element's SOURCE lane of its slot row
        sub = (torch.gather(code, 2, (group * LANES + lane).expand(nt, K, T)) >> 7) & 7
        kt = (torch.arange(K, device=dev) // SLOTS)[None, :, None]
        pos = ((group * KT + kt) * nw + sub // sp).reshape(nt, K * T)
        scr = torch.gather(A.cbase[:nt].long(), 1, pos).reshape(nt, K, T) + sub % sp
    else:
        lane = code
        cb = A.cbase[:nt].long().reshape(nt, B, K).transpose(1, 2)
        scr = cb.repeat_interleave(LANES, dim=2)
    w = torch.clamp(scr // sr, max=A.n_win - 1)
    chunk = torch.gather(A.span_row.long(), 1, w.reshape(nt, K * T)).reshape(nt, K, T)
    return (chunk + scr % sr) * LANES + lane


def pell_step_ref(A: PellMatrix, x: torch.Tensor, v_prev: Optional[torch.Tensor] = None,
                  d: float = 0.0, sb: float = 0.0) -> torch.Tensor:
    """Plain version of K4/K5: ``y = A x - d x - sb v_prev`` on vectors of
    length ``n_x`` (zero beyond ``n``); returns (n_x,) with a zero tail
    past ``n_pad``."""
    nt, K, T = A.ntiles, A.k_slots, A.tile
    n_pad = A.n_pad
    acc = (A.vals.reshape(nt, K, T) * x[_columns(A)]).sum(dim=1).reshape(-1)
    y = x.new_zeros(A.n_x)
    y[:n_pad] = acc - d * x[:n_pad]
    if v_prev is not None:
        y[:n_pad] -= sb * v_prev[:n_pad]
    return y


def _padded(A: PellMatrix, v: torch.Tensor) -> torch.Tensor:
    if v.ndim != 1 or v.shape[0] != A.n:
        raise ValueError(f"expected a vector of length {A.n}, got shape {tuple(v.shape)}")
    if A.n_x == A.n:
        return v.contiguous()
    return torch.nn.functional.pad(v, (0, A.n_x - A.n))


def pell_apply(A: PellMatrix, x: torch.Tensor, vprev: Optional[torch.Tensor] = None,
               d: float = 0.0, sb: float = 0.0) -> torch.Tensor:
    """``y = A x - d x - sb v_prev`` on (n,) vectors (zero-padded to
    ``n_x`` internally): one kernel launch on CUDA, the plain version on
    CPU.  x must have the planes' dtype: nothing is cast."""
    from ca_lanczos_tpu_torch.ops.cuda_pell import pell_step

    xp = _padded(A, x)
    vp = None if vprev is None else _padded(A, vprev)
    return pell_step(A, xp, vp, d, sb)[: A.n]


def matrix_powers_pell(A: PellMatrix, q: torch.Tensor, s: int, diag=None,
                       sub=None) -> torch.Tensor:
    """[q, P_1(A)q, ..., P_s(A)q] (n, s+1), like ``matrix_powers_monomial``:
    s kernel launches, step k fusing ``- diag[k] V[:,k] - sub[k] V[:,k-1]``
    (JAX scans ``spmv(A, v) - d v - sb v_prev`` instead; same function).
    Each step writes into a row of one (s+1, n_x) buffer; the result is
    its (n, s+1) transposed view."""
    from ca_lanczos_tpu_torch.ops.cuda_pell import pell_step

    n, n_pad, n_x = A.n, A.n_pad, A.n_x
    diag = np.zeros(s) if diag is None else np.asarray(diag, np.float64)
    sub = np.zeros(s) if sub is None else np.asarray(sub, np.float64)
    V = q.new_empty((s + 1, n_x))
    V[0, :n] = q
    V[0, n:] = 0
    V[1:, n_pad:] = 0  # the steps write rows [0, n_pad)
    for k in range(s):
        pell_step(A, V[k], V[k - 1] if k else None, float(diag[k]), float(sub[k]),
                  out=V[k + 1])
    return V[:, :n].T
