"""Automatic operator-format routing: scipy/dense input -> an operator.

Counterpart of ``ca_lanczos_tpu/ops/formats.py``.  ``make_operator`` is the
production entry for "I have a matrix, give me an operator on this
device":

  1. tiny           -> DenseMatrix
  2. few diagonals  -> IlvDiaMatrix (interleaved s-step kernel K3; on a
                       CUDA device, f32 planes, pad waste <= 1.25x, s=8
                       halo bound — exactly where the TPU package upgrades
                       on a device backend) else DiaMatrix (K1/K2)
  3. windowed nnz   -> the PELL rung, which raises NotImplementedError
                       until the general-sparsity kernels K4/K5 are ported
                       (ROADMAP A.9).  Whether PELL takes the matrix is
                       decided exactly as the TPU encoder's window plan
                       decides it (``_pell_window_overflow``).
  4. scattered      -> RCM reorder, then re-route the permuted matrix
                       through 2-3 (the route carries the permutation)
  5. everything else-> EllMatrix (plain gather; correct but slow)

The returned ``OperatorRoute`` records the decision and carries the
permutation (identity when none), so eigenvectors map back with
``route.restore(V)``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.spmv import DenseMatrix, DiaMatrix, EllMatrix

Routable = Union[DenseMatrix, DiaMatrix, EllMatrix]  # and IlvDiaMatrix (duck-typed)

_PELL_TODO = (
    "general sparsity routes to the PELL kernels K4/K5, not yet ported to "
    "CUDA (ROADMAP A.9); pass prefer='ell' for the plain ELL operator"
)
_LANES = 128  # PELL chunk width (ops/pell.py LANES)


def _pell_window_overflow(csr, tile: int = 1024, max_windows: int = 16,
                          sw: Optional[int] = None) -> Optional[str]:
    """Why the TPU package's PELL encoder would reject ``csr`` (its window
    plan, ``PellMatrix.from_scipy`` pass 1 and the window lists), or None
    when it would take it.  Host numpy, copied from the encoder so both
    packages route the same inputs the same way."""
    indptr, indices = csr.indptr, csr.indices
    n = csr.shape[0]
    ntiles = -(-n // tile)
    g_tot = ntiles * tile // _LANES
    SW_MAX, SW_MULTI = 65536, 16384
    need = 0
    tile_chunks = []
    for t in range(ntiles):
        lo_r, hi_r = t * tile, min((t + 1) * tile, n)
        seg = indices[indptr[lo_r]:indptr[hi_r]]
        cmin = int(seg.min()) if seg.size else lo_r
        cmax = int(seg.max()) if seg.size else lo_r
        need = max(need, cmax + 1 - (cmin // 1024) * 1024)
        tile_chunks.append(np.unique(seg // _LANES).astype(np.int64) if seg.size
                           else np.asarray([lo_r // _LANES], np.int64))
    need = ((need + 1023) // 1024) * 1024

    def windows(chunks, srq, g_x=None):
        i, wins = 0, []
        while i < len(chunks):
            start = (int(chunks[i]) // 8) * 8  # 1024-element alignment
            if g_x is not None:
                start = min(start, g_x - srq)
            wins.append(start)
            i = int(np.searchsorted(chunks, start + srq, side="left"))
        return len(wins)

    if sw is None:
        if need <= SW_MAX:
            sw = need
        else:
            # the encoder's multi-window width: least fetch within max_windows
            best = None
            for cand in (1024, 2048, 4096, 8192, SW_MULTI, 32768):
                tot = mx = 0
                for ch in tile_chunks:
                    c = windows(ch, cand // _LANES)
                    tot, mx = tot + c, max(mx, c)
                    if mx > max_windows:
                        break
                if mx <= max_windows and (best is None or tot * (cand + 2048) < best[0]):
                    best = (tot * (cand + 2048), cand)
            sw = best[1] if best else SW_MULTI
    sw = max(((sw + 1023) // 1024) * 1024, 1024)
    sw = min(sw, max(((ntiles * tile + 1023) // 1024) * 1024, 1024))
    sr = sw // _LANES
    g_x = max(g_tot, sr)
    for t, chunks in enumerate(tile_chunks):
        nw = windows(chunks, sr, g_x)
        if nw > max_windows:
            return (f"PELL window overflow: row tile {t} needs {nw} windows of {sw}"
                    f" columns (> max_windows={max_windows})")
    return None


def dia_from_scipy(
    a,
    max_diags: int = 64,
    waste_cap: float = 8.0,
    dtype=None,
    device="cpu",
) -> Optional[DiaMatrix]:
    """DIA storage of a scipy matrix when it is diagonal-sparse, else None:
    at most ``max_diags`` distinct diagonals and dense-plane padding
    ``len(offsets) * n`` within ``waste_cap`` x nnz.  O(nnz log nnz)."""
    import scipy.sparse as sp

    coo = sp.coo_matrix(a)
    coo.sum_duplicates()
    n = coo.shape[0]
    if coo.shape[0] != coo.shape[1]:
        raise ValueError("square matrices only")
    if np.iscomplexobj(coo.data):
        raise ValueError("real matrices only (astype would silently drop imaginary parts)")
    if dtype is None:
        dtype = np.float64 if coo.data.dtype == np.float64 else np.float32
    if coo.nnz == 0:
        return DiaMatrix(data=torch.zeros((1, n), dtype=_torch_dtype(dtype), device=device),
                         offsets=(0,))
    offs_e = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offsets = np.unique(offs_e)
    if len(offsets) > max_diags or len(offsets) * n > waste_cap * coo.nnz:
        return None
    data = np.zeros((len(offsets), n), dtype)
    k = np.searchsorted(offsets, offs_e)
    data[k, coo.row] = coo.data.astype(dtype)
    return DiaMatrix(data=torch.from_numpy(data).to(device),
                     offsets=tuple(int(d) for d in offsets))


def _torch_dtype(dtype) -> torch.dtype:
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


@dataclasses.dataclass
class OperatorRoute:
    """Record of a ``make_operator`` decision.

    perm is new_index -> old_index; None means no reordering and
    apply/restore are identity.  n_orig: set when the route zero-padded
    the operator (the ilv route pads to a multiple of 8192 rows); then
    ``apply`` embeds original-order vectors into the padded domain and
    ``restore`` truncates back.  numpy in, numpy out; tensor in, tensor
    out on the same device.
    """

    format: str  # "dense" | "dia" | "ilv" | "ell"
    perm: Optional[np.ndarray]
    notes: List[str]
    nnz: int
    bandwidth_before: Optional[int] = None
    bandwidth_after: Optional[int] = None
    n_orig: Optional[int] = None

    def apply(self, x):
        """Map original-order vectors/multivectors into operator order."""
        if self.perm is None:
            return x
        if isinstance(x, torch.Tensor):
            if len(self.perm) > x.shape[0]:
                pad = x.new_zeros((len(self.perm) - x.shape[0],) + tuple(x.shape[1:]))
                x = torch.cat([x, pad], dim=0)
            return x[torch.as_tensor(self.perm, device=x.device)]
        x = np.asarray(x)
        if len(self.perm) > x.shape[0]:
            pad = np.zeros((len(self.perm) - x.shape[0],) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        return x[self.perm]

    def restore(self, x):
        """Map operator-order vectors/multivectors back to original order."""
        if self.perm is not None:
            if isinstance(x, torch.Tensor):
                out = torch.empty_like(x)
                out[torch.as_tensor(self.perm, device=x.device)] = x
            else:
                x = np.asarray(x)
                out = np.empty_like(x)
                out[self.perm] = x
            x = out
        if self.n_orig is not None:
            x = x[: self.n_orig]
        return x


def _gershgorin_mid(csr) -> float:
    """Midpoint of the Gershgorin spectrum hull — strictly inside the
    spectrum, so padding rows given this diagonal value never surface
    among extreme Ritz values (largest OR smallest targeting)."""
    diag = np.asarray(csr.diagonal(), np.float64)
    absrow = np.asarray(np.abs(csr).sum(axis=1)).ravel().astype(np.float64)
    rad = absrow - np.abs(diag)
    return 0.5 * (float((diag - rad).min()) + float((diag + rad).max()))


def _maybe_ilv(A: DiaMatrix, csr, notes: List[str], ilv, device: torch.device):
    """Upgrade a host-plane DiaMatrix to the interleaved carrier K3 serves.

    Returns (IlvDiaMatrix on ``device``, perm_il (n_pad new->old), n_pad)
    or None.  ``ilv``: "auto" upgrades float32 planes on a CUDA device;
    True forces (casting planes to float32); False disables.

    The operator is zero-padded to the TPU package's 8192-row unit (kept
    so both packages give the same route for the same input); pad rows get
    the Gershgorin-midpoint diagonal so their eigenvalues sit strictly
    inside the spectrum hull.  The TPU package also required its VMEM tile
    picker to find a tile, which fails only beyond ~75 diagonals, past
    ``max_diags``'s default of 64.
    """
    from ca_lanczos_tpu_torch.ops.cuda_ilv import J, WQ, IlvDiaMatrix

    if ilv is False:
        return None
    data = A.data.numpy()
    nd, n = data.shape
    w = max((abs(o) for o in A.offsets), default=0)
    if 8 * ((w + J - 1) // J) > WQ:  # production s=8 must fit the q-halo
        if ilv is True:
            raise ValueError(
                f"ilv forced but bandwidth {w} exceeds the s=8 halo bound "
                f"(need 8*ceil(w/{J}) <= {WQ})"
            )
        return None
    if ilv == "auto":
        if device.type != "cuda":
            return None
        if data.dtype != np.float32:
            notes.append("ilv skipped: planes not float32 (force with prefer='ilv')")
            return None
    n_pad = max(2 * 8192, -(-n // 8192) * 8192)
    if ilv == "auto" and n_pad > 1.25 * n:
        notes.append(f"ilv skipped: pad waste {n_pad / n:.2f}x > 1.25x")
        return None
    pdata = np.zeros((nd, n_pad), np.float32)
    pdata[:, :n] = data.astype(np.float32)
    if n_pad > n and 0 in A.offsets:
        pdata[A.offsets.index(0), n:] = np.float32(_gershgorin_mid(csr))
    Ail = IlvDiaMatrix.from_dia(
        DiaMatrix(data=torch.from_numpy(pdata).to(device), offsets=A.offsets), keep_dia=True
    )
    nq = n_pad // J
    perm_il = np.arange(n_pad).reshape(nq, J).T.reshape(-1)
    notes.append(f"ilv: interleaved carrier, n {n} -> {n_pad}")
    return Ail, perm_il, n_pad


def negate_operator(A):
    """-A in the same format (value planes negated).  Lanczos drivers lock
    the LARGEST Ritz pairs; solving -A and negating the eigenvalues back
    targets the smallest end."""
    from ca_lanczos_tpu_torch.ops.cuda_ilv import IlvDiaMatrix

    if isinstance(A, DiaMatrix):
        return DiaMatrix(data=-A.data, offsets=A.offsets)
    if isinstance(A, IlvDiaMatrix):
        return dataclasses.replace(
            A, data_il=-A.data_il,
            dia_data=None if A.dia_data is None else -A.dia_data,
        )
    if isinstance(A, EllMatrix):
        return EllMatrix(vals=-A.vals, cols=A.cols)
    if isinstance(A, DenseMatrix):
        return DenseMatrix(a=-A.a)
    raise TypeError(f"cannot negate {type(A).__name__}")


def make_operator(
    a,
    *,
    prefer: str = "auto",
    dense_cutoff: int = 2048,
    max_diags: int = 64,
    dia_waste_cap: float = 8.0,
    tile: int = 1024,
    max_windows: int = 16,
    sw: Optional[int] = None,
    allow_reorder: bool = True,
    allow_ell_fallback: bool = True,
    ilv="auto",
    device="cpu",
) -> Tuple[Routable, OperatorRoute]:
    """Route any square scipy.sparse / dense matrix to an operator on
    ``device``.

    prefer: "auto" routes per the module docstring; "dense" / "dia" /
    "ilv" / "ell" force that format ("pell" raises NotImplementedError).
    tile / max_windows / sw: the PELL encoder's plan, which decides
    whether PELL takes the matrix.  ilv: "auto" upgrades f32 DIA routes on
    a CUDA device to the interleaved carrier; False keeps DiaMatrix; True
    forces it.

    Returns (operator, route).  When route.perm is not None the caller
    runs the solver on ``route.apply(r0)`` and maps Ritz vectors back with
    ``route.restore(V)``; eigenVALUES are permutation-invariant.
    """
    import scipy.sparse as sp

    device = torch.device(device)
    csr = sp.csr_matrix(a) if sp.issparse(a) else sp.csr_matrix(np.asarray(a))
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("square matrices only")
    if np.iscomplexobj(csr.data):
        raise ValueError("real matrices only (astype would silently drop imaginary parts)")
    csr.sum_duplicates()
    csr.sort_indices()
    n = csr.shape[0]
    nnz = int(csr.nnz)
    notes: List[str] = []

    if prefer == "dense" or (prefer == "auto" and n <= dense_cutoff):
        dtype = np.float64 if csr.dtype == np.float64 else np.float32
        A = DenseMatrix(a=torch.from_numpy(csr.toarray().astype(dtype)).to(device))
        notes.append(f"n={n} <= dense_cutoff={dense_cutoff}"
                     if prefer == "auto" else "forced dense")
        return A, OperatorRoute("dense", None, notes, nnz)
    if prefer == "dia":
        A = dia_from_scipy(csr, max_diags=max_diags, waste_cap=dia_waste_cap, device=device)
        if A is None:
            raise ValueError(
                f"matrix does not qualify for DIA (max_diags={max_diags},"
                f" waste_cap={dia_waste_cap})"
            )
        return A, OperatorRoute("dia", None, ["forced dia"], nnz)
    if prefer == "ilv":
        Ah = dia_from_scipy(csr, max_diags=max_diags, waste_cap=dia_waste_cap)
        if Ah is None:
            raise ValueError(
                f"matrix does not qualify for DIA/ilv (max_diags={max_diags},"
                f" waste_cap={dia_waste_cap})"
            )
        Ail, perm_il, _ = _maybe_ilv(Ah, csr, notes, True, device)
        return Ail, OperatorRoute("ilv", perm_il, ["forced ilv"] + notes, nnz, n_orig=n)
    if prefer == "pell":
        raise NotImplementedError(_PELL_TODO)
    if prefer == "ell":
        return (EllMatrix.from_scipy(csr, device=device),
                OperatorRoute("ell", None, ["forced ell"], nnz))
    if prefer != "auto":
        raise ValueError(f"unknown prefer={prefer!r}")

    def route_csr(m):
        """DIA (host planes: the ilv upgrade repacks them), else the PELL
        rung: NotImplementedError when PELL would take ``m``, None when its
        window plan rejects it."""
        A = dia_from_scipy(m, max_diags=max_diags, waste_cap=dia_waste_cap)
        if A is not None:
            return A
        why = _pell_window_overflow(m, tile=tile, max_windows=max_windows, sw=sw)
        if why is None:
            raise NotImplementedError(_PELL_TODO)
        notes.append(f"pell rejected: {why}")
        return None

    def finish(A, perm, m, bw_b=None, bw_a=None):
        """Upgrade a DIA win to the ilv carrier (composing the interleave
        permutation with any RCM perm); move it to the device otherwise."""
        up = _maybe_ilv(A, m, notes, ilv, device)
        if up is not None:
            Ail, perm_il, n_pad = up
            total = perm_il if perm is None else np.concatenate(
                [np.asarray(perm), np.arange(n, n_pad)])[perm_il]
            return Ail, OperatorRoute("ilv", total, notes, nnz, bw_b, bw_a, n_orig=n)
        return A.to(device), OperatorRoute("dia", perm, notes, nnz, bw_b, bw_a)

    A = route_csr(csr)
    if A is not None:
        return finish(A, None, csr)
    bw_before = bw_after = None
    if allow_reorder and nnz:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm = np.asarray(reverse_cuthill_mckee(csr, symmetric_mode=True))
        csr_p = csr[perm][:, perm].tocsr()
        csr_p.sort_indices()
        coo0, coo1 = csr.tocoo(), csr_p.tocoo()
        bw_before = int(np.max(np.abs(coo0.row - coo0.col)))
        bw_after = int(np.max(np.abs(coo1.row - coo1.col)))
        notes.append(f"rcm: bandwidth {bw_before} -> {bw_after}")
        A = route_csr(csr_p)
        if A is not None:
            return finish(A, perm, csr_p, bw_before, bw_after)
        if allow_ell_fallback:
            notes.append("ell fallback (plain gather path)")
            return (EllMatrix.from_scipy(csr_p, device=device),
                    OperatorRoute("ell", perm, notes, nnz, bw_before, bw_after))
    if allow_ell_fallback:
        notes.append("ell fallback (plain gather path)")
        return (EllMatrix.from_scipy(csr, device=device),
                OperatorRoute("ell", None, notes, nnz, bw_before, bw_after))
    raise ValueError("no fast format fits this sparsity and fallbacks are disabled: "
                     + "; ".join(notes))
