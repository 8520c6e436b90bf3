"""Automatic operator-format routing: scipy/dense input -> an operator.

Counterpart of ``ca_lanczos_tpu/ops/formats.py``.  ``make_operator`` is the
production entry for "I have a matrix, give me an operator on this
device":

  1. tiny           -> DenseMatrix
  2. few diagonals  -> IlvDiaMatrix (interleaved s-step kernel K3; on a
                       CUDA device, f32 planes, pad waste <= 1.25x, s=8
                       halo bound — exactly where the TPU package upgrades
                       on a device backend) else DiaMatrix (K1/K2)
  3. windowed nnz   -> PellMatrix (general-sparsity kernels K4/K5); the
                       encoder (``PellMatrix.encode``, the JAX package's,
                       or its unit planes built on a CUDA device,
                       ``ops.pell_card``) decides, and its window-overflow
                       ValueError sends the matrix on to 4
  4. scattered      -> RCM reorder, then re-route the permuted matrix
                       through 2-3 (the route carries the permutation)
  5. everything else-> EllMatrix (plain gather; correct but slow)

The returned ``OperatorRoute`` records the decision and carries the
permutation (identity when none), so eigenvectors map back with
``route.restore(V)``.  ``save_operator`` / ``load_operator_npz`` store an
encoded operator and its route in one ``.npz`` with the JAX package's
keys, so either package reads the other's PELL/DIA/ELL/dense files.

Every entry point puts the operator on ``device="cuda"`` unless told
otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ca_lanczos_tpu_torch.ops.pell import LANES, SLOT_FILL, PellMatrix
from ca_lanczos_tpu_torch.ops.pell_card import encode_for_route
from ca_lanczos_tpu_torch.ops.spmv import DenseMatrix, DiaMatrix, EllMatrix

Routable = Union[DenseMatrix, DiaMatrix, EllMatrix, PellMatrix]  # and IlvDiaMatrix


def dia_from_scipy(
    a,
    max_diags: int = 64,
    waste_cap: float = 8.0,
    dtype=None,
    device="cuda",
) -> Optional[DiaMatrix]:
    """DIA storage of a scipy matrix when it is diagonal-sparse, else None:
    at most ``max_diags`` distinct diagonals and dense-plane padding
    ``len(offsets) * n`` within ``waste_cap`` x nnz.  Built on ``device``
    in O(n + nnz): the CSR arrays are copied there, and the offsets, each
    entry's plane and the scatter run there (``device="cpu"`` builds on
    the host)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(a)
    csr.sum_duplicates()  # a no-op on a canonical CSR
    n = csr.shape[0]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("square matrices only")
    if np.iscomplexobj(csr.data):
        raise ValueError("real matrices only (astype would silently drop imaginary parts)")
    if dtype is None:
        dtype = np.float64 if csr.data.dtype == np.float64 else np.float32
    tdtype = _torch_dtype(dtype)
    if csr.nnz == 0:
        return DiaMatrix(data=torch.zeros((1, n), dtype=tdtype, device=device), offsets=(0,))
    dev = torch.device(device)
    counts = torch.from_numpy(np.diff(csr.indptr)).to(dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev), counts, output_size=csr.nnz)
    shift = torch.from_numpy(csr.indices).to(dev).long() - rows + (n - 1)  # offset + n - 1
    present = torch.bincount(shift, minlength=2 * n - 1) > 0
    offsets = torch.nonzero(present).squeeze(1) - (n - 1)
    nd = int(offsets.numel())
    if nd > max_diags or nd * n > waste_cap * csr.nnz:
        return None
    plane = torch.cumsum(present, 0) - 1  # each offset's plane, by offset + n - 1
    data = torch.zeros((nd, n), dtype=tdtype, device=dev)
    data.view(-1)[plane[shift] * n + rows] = torch.from_numpy(csr.data).to(dev).to(tdtype)
    return DiaMatrix(data=data, offsets=tuple(int(d) for d in offsets.tolist()))


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

    format: str  # "dense" | "dia" | "ilv" | "pell" | "ell"
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
    if isinstance(A, PellMatrix):
        return dataclasses.replace(A, vals=-A.vals)
    raise TypeError(f"cannot negate {type(A).__name__}")


def save_operator(path: str, A: Routable, route: Optional[OperatorRoute] = None) -> None:
    """Store an encoded operator (and its route) in one ``.npz`` with the
    JAX package's keys: encode once on a host, solve many times.  A
    DiaMatrix, EllMatrix, DenseMatrix or PellMatrix round-trips bit for
    bit; an IlvDiaMatrix is stored as its normal-layout planes (without
    the TPU tile ``tq`` the JAX package also writes)."""
    from ca_lanczos_tpu_torch.ops.cuda_ilv import IlvDiaMatrix

    def h(t):
        return t.detach().cpu().numpy()

    if isinstance(A, DiaMatrix):
        arrs = dict(kind="dia", data=h(A.data), offsets=np.asarray(A.offsets, np.int64))
    elif isinstance(A, IlvDiaMatrix):
        if A.dia_data is None:
            raise ValueError("IlvDiaMatrix without dia_data cannot be serialized "
                             "(construct with keep_dia=True)")
        arrs = dict(kind="ilv", data=h(A.dia_data), offsets=np.asarray(A.offsets, np.int64))
    elif isinstance(A, EllMatrix):
        arrs = dict(kind="ell", vals=h(A.vals), cols=h(A.cols))
    elif isinstance(A, DenseMatrix):
        arrs = dict(kind="dense", a=h(A.a))
    elif isinstance(A, PellMatrix):
        arrs = dict(
            kind="pell", vals=h(A.vals), lidx=h(A.lidx), cbase=h(A.cbase),
            span_row=h(A.span_row),
            statics=np.asarray([A.n, A.tile, A.k_slots, A.sw, A.nnz_count, A.n_win],
                               np.int64),
            enc=np.asarray(A.enc),
        )
    else:
        raise TypeError(f"cannot serialize {type(A).__name__}")
    if route is not None:
        arrs["route_format"] = np.asarray(route.format)
        arrs["route_nnz"] = np.asarray(route.nnz, np.int64)
        arrs["route_notes"] = np.asarray("\n".join(route.notes))
        if route.perm is not None:
            arrs["route_perm"] = np.asarray(route.perm, np.int64)
        if route.n_orig is not None:
            arrs["route_n_orig"] = np.asarray(route.n_orig, np.int64)
    np.savez_compressed(path, **arrs)


def load_operator_npz(path: str, device="cuda") -> Tuple[Routable, Optional[OperatorRoute]]:
    """Inverse of :func:`save_operator` (also reads the JAX package's
    files), with the operator on ``device``."""
    from ca_lanczos_tpu_torch.ops.cuda_ilv import IlvDiaMatrix

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        if kind in ("dia", "ilv"):
            A = DiaMatrix(data=t(z["data"]), offsets=tuple(int(o) for o in z["offsets"]))
            if kind == "ilv":
                A = IlvDiaMatrix.from_dia(A, keep_dia=True)
        elif kind == "ell":
            A = EllMatrix(vals=t(z["vals"]), cols=t(z["cols"], torch.int64))
        elif kind == "dense":
            A = DenseMatrix(a=t(z["a"]))
        elif kind == "pell":
            n, tile, k_slots, sw, nnz_count, n_win = (int(v) for v in z["statics"])
            A = PellMatrix(vals=t(z["vals"]), lidx=t(z["lidx"]), cbase=t(z["cbase"]),
                           span_row=t(z["span_row"]), n=n, tile=tile, k_slots=k_slots,
                           sw=sw, nnz_count=nnz_count, n_win=n_win, enc=str(z["enc"]))
        else:
            raise ValueError(f"unknown operator kind {kind!r} in {path}")
        route = None
        if "route_format" in z:
            notes = str(z["route_notes"])
            route = OperatorRoute(
                format=str(z["route_format"]),
                perm=np.asarray(z["route_perm"]) if "route_perm" in z else None,
                notes=notes.split("\n") if notes else [],
                nnz=int(z["route_nnz"]),
                n_orig=int(z["route_n_orig"]) if "route_n_orig" in z else None,
            )
    return A, route


def make_operator(
    a,
    *,
    prefer: str = "auto",
    dense_cutoff: int = 2048,
    max_diags: int = 64,
    dia_waste_cap: float = 8.0,
    tile: int = 1024,
    encoding: str = "auto",
    max_windows: int = 16,
    sw: Optional[int] = None,
    allow_reorder: bool = True,
    allow_ell_fallback: bool = True,
    ilv="auto",
    device="cuda",
) -> Tuple[Routable, OperatorRoute]:
    """Route any square scipy.sparse / dense matrix to an operator on
    ``device``.

    prefer: "auto" routes per the module docstring; "dense" / "dia" /
    "ilv" / "pell" / "ell" force that format.  tile / encoding /
    max_windows / sw: the PELL encoder's arguments (``encoding`` "unit",
    "grouped", "grouped4" or "auto").  ilv: "auto" upgrades f32 DIA routes
    on a CUDA device to the interleaved carrier; False keeps DiaMatrix;
    True forces it.

    Returns (operator, route).  When route.perm is not None the caller
    runs the solver on ``route.apply(r0)`` and maps Ritz vectors back with
    ``route.restore(V)``; eigenVALUES are permutation-invariant.
    """
    import scipy.sparse as sp

    from ca_lanczos_tpu_torch.utils.spans import span  # utils imports ops

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
        A = dia_from_scipy(csr, max_diags=max_diags, waste_cap=dia_waste_cap, device="cpu")
        if A is None:
            raise ValueError(
                f"matrix does not qualify for DIA (max_diags={max_diags},"
                f" waste_cap={dia_waste_cap})"
            )
        with span("route.copy"):
            return A.to(device), OperatorRoute("dia", None, ["forced dia"], nnz)
    if prefer == "ilv":
        Ah = dia_from_scipy(csr, max_diags=max_diags, waste_cap=dia_waste_cap, device="cpu")
        if Ah is None:
            raise ValueError(
                f"matrix does not qualify for DIA/ilv (max_diags={max_diags},"
                f" waste_cap={dia_waste_cap})"
            )
        Ail, perm_il, _ = _maybe_ilv(Ah, csr, notes, True, device)
        return Ail, OperatorRoute("ilv", perm_il, ["forced ilv"] + notes, nnz, n_orig=n)
    def pell(m):
        """The PELL planes of ``m``: encoded on the card when ``device`` is
        CUDA and the planes are unit, else on the host (span
        ``route.encode``, its args the encoding asked for;
        ``ops.pell_card.encode_for_route``), then made a PellMatrix on
        ``device`` (``route.copy``, its args the encoder's choice), its
        stored values and walked slot entries counted in
        ``ops.pell.SLOT_FILL``."""
        with span("route.encode", encoding):
            planes = encode_for_route(m, device, tile=tile, encoding=encoding,
                                      max_windows=max_windows, sw=sw)
        with span("route.copy", f"{planes.enc} n_win={planes.n_win} "
                                f"k_slots={planes.k_slots} {planes.encoder}"):
            A = planes.to(device)
            SLOT_FILL["nnz"] += A.nnz
            SLOT_FILL["walked"] += int(A.slot_count.clamp(max=A.k_slots).sum()) * LANES
            return A

    if prefer == "pell":
        return pell(csr), OperatorRoute("pell", None, ["forced pell"], nnz)
    if prefer == "ell":
        return (EllMatrix.from_scipy(csr, device=device),
                OperatorRoute("ell", None, ["forced ell"], nnz))
    if prefer != "auto":
        raise ValueError(f"unknown prefer={prefer!r}")

    def route_csr(m):
        """DIA (host planes: the ilv upgrade repacks them), else PELL on
        ``device``, else None (the encoder's window overflow)."""
        A = dia_from_scipy(m, max_diags=max_diags, waste_cap=dia_waste_cap, device="cpu")
        if A is not None:
            return A
        try:
            return pell(m)
        except ValueError as e:  # window overflow
            notes.append(f"pell rejected: {e}")
            return None

    def finish(A, perm, m, bw_b=None, bw_a=None):
        """Upgrade a DIA win to the ilv carrier (composing the interleave
        permutation with any RCM perm); move it to the device otherwise."""
        if isinstance(A, PellMatrix):
            return A, OperatorRoute("pell", perm, notes, nnz, bw_b, bw_a)
        up = _maybe_ilv(A, m, notes, ilv, device)
        if up is not None:
            Ail, perm_il, n_pad = up
            total = perm_il if perm is None else np.concatenate(
                [np.asarray(perm), np.arange(n, n_pad)])[perm_il]
            return Ail, OperatorRoute("ilv", total, notes, nnz, bw_b, bw_a, n_orig=n)
        with span("route.copy"):
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
