"""Synthetic validation corpus spanning the reference's matrix families.

Counterpart of ``ca_lanczos_tpu/harness/corpus.py``: the same 23 families,
seeds, normalisation and dense oracles, with the operators on ``device``.
The reference validates on 105 SuiteSparse matrices (families listed at
get_matrix_info.m:3-11 / test_restarted_ca_lanczos_all_matrices.m:6-14);
with no network the corpus is synthesized to cover the same structural
families: banded stiffness, 2-D/3-D meshes, power-of-two-offset
(Trefethen), graph Laplacians, indefinite, clustered, and
ill-conditioned spectra up to cond ~1e8.  Every matrix is normalized by
its infinity norm before use, like the reference sweep (:31-32).

Each entry returns (operator, exact_eigenvalues) with the oracle from a
dense symmetric eigendecomposition (test_restart_general_matrices.m:23-29).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix, EllMatrix, Operator
from ca_lanczos_tpu_torch.utils.reorder import rcm_reorder


def _finalize(a, device, max_dia_offsets: int = 48) -> Tuple[Operator, np.ndarray]:
    """Normalize by the infinity norm, pick DIA or ELL by diagonal count,
    and compute the dense oracle spectrum."""
    a = sp.csr_matrix(a)
    a = (a + a.T) * 0.5  # enforce exact symmetry
    inf_norm = np.max(np.abs(a).sum(axis=1))
    a = a / inf_norm
    dense = a.toarray()
    eigs = np.linalg.eigvalsh(dense)
    offsets = np.unique(sp.dia_matrix(a).offsets)
    if len(offsets) <= max_dia_offsets:
        op: Operator = DiaMatrix.from_dense(dense, device=device)
    else:
        op = EllMatrix.from_scipy(a, device=device)
    return op, eigs


def _diag(vals, device) -> Tuple[Operator, np.ndarray]:
    vals = np.asarray(vals, np.float64)
    vals = vals / np.max(np.abs(vals))
    return (
        DiaMatrix(data=torch.as_tensor(vals, device=device)[None, :], offsets=(0,)),
        np.sort(vals),
    )


def _lap1d(n):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (n, n))


def _lap2d(nx, ny, ax=1.0, ay=1.0):
    return sp.kronsum(ax * _lap1d(nx), ay * _lap1d(ny))


def build_corpus(small: bool = False, device="cuda") -> Dict[str, Tuple[Operator, np.ndarray]]:
    """23 matrices across the reference families on ``device``;
    ``small=True`` shrinks sizes for tests."""
    rng = np.random.default_rng(42)
    n = 256 if small else 1000
    g = 14 if small else 31  # 2-D grid edge

    def fin(a):
        return _finalize(a, device)

    out: Dict[str, Tuple[Operator, np.ndarray]] = {}

    # -- diagonal analytic spectra (test_convergence_diagonal_matrices.m:9-21)
    out["diag_lin_1e2"] = _diag(np.linspace(1.0, 1e2, n), device)
    out["diag_lin_1e4"] = _diag(np.linspace(1.0, 1e4, n), device)
    out["diag_lin_1e6"] = _diag(np.linspace(1.0, 1e6, n), device)
    # plat*-like near-singular: cond 1e8
    out["diag_geom_1e8"] = _diag(np.geomspace(1e-8, 1.0, n), device)
    # Strakos: clustered small + separated large (classic orth-loss test)
    rho, l1, ln = 0.9, 0.1, 100.0
    i = np.arange(1, n + 1)
    strakos = l1 + (i - 1) / (n - 1) * (ln - l1) * rho ** (n - i)
    out["diag_strakos"] = _diag(strakos, device)
    # clustered top (locking stress)
    clus = np.concatenate([np.linspace(1, 50, n - 8), 99.0 + 0.05 * np.arange(8)])
    out["diag_clustered"] = _diag(clus, device)

    # -- banded stiffness (bcsstk-like)
    out["stiff_1d"] = fin(_lap1d(n))
    beam = sp.diags([1.0, -4.0, 6.0, -4.0, 1.0], [-2, -1, 0, 1, 2], (n, n))
    out["stiff_beam4"] = fin(beam)
    c = 1.0 + 9.0 * rng.random(n)  # random coefficient field
    out["stiff_randcoef"] = fin(sp.diags(c) @ _lap1d(n) @ sp.diags(c))
    w = 8 if small else 16
    band = sp.random(n, n, density=min(1.0, 3.0 / w / 2), random_state=1)
    band = sp.csr_matrix(band)
    bi, bj = band.nonzero()
    keep = np.abs(bi - bj) <= w
    band = sp.csr_matrix((band.data[keep], (bi[keep], bj[keep])), shape=(n, n))
    out["band_random_w16"] = fin(band + band.T + 4.0 * w * sp.eye(n))

    # -- meshes
    out["mesh_2d"] = fin(_lap2d(g, g))
    out["mesh_2d_aniso"] = fin(_lap2d(g, g, ax=1.0, ay=100.0))
    m3 = 6 if small else 10
    out["mesh_3d"] = fin(sp.kronsum(sp.kronsum(_lap1d(m3), _lap1d(m3)), _lap1d(m3)))
    # 9-point stencil
    nine = _lap2d(g, g) + sp.kron(_lap1d(g), _lap1d(g)) * 0.25
    out["mesh_2d_9pt"] = fin(nine)

    # -- Trefethen_*: primes on the diagonal, 1s at power-of-2 offsets
    def primes_upto_count(k):
        ps, cand = [], 2
        while len(ps) < k:
            if all(cand % p for p in ps if p * p <= cand):
                ps.append(cand)
            cand += 1
        return np.asarray(ps, np.float64)

    tref = sp.diags(primes_upto_count(n)).tolil()
    off = 1
    while off < n:
        tref.setdiag(1.0, off)
        tref.setdiag(1.0, -off)
        off *= 2
    out["trefethen"] = fin(tref)

    # -- indefinite (shifted meshes; mhd*-like mixed sign)
    lap = _lap2d(g, g)
    sigma = 4.0  # interior shift -> indefinite
    out["indef_shifted_mesh"] = fin(lap - sigma * sp.eye(g * g))
    scale = sp.diags(np.concatenate([np.ones(n // 2), -np.ones(n - n // 2)]))
    out["indef_scaled_band"] = fin(scale @ _lap1d(n) @ scale)

    # -- graph Laplacians (bus/nos-like)
    er = sp.random(n, n, density=8.0 / n, random_state=2)
    er = sp.csr_matrix((np.ones_like(er.data), er.nonzero()), shape=(n, n))
    er = ((er + er.T) > 0).astype(np.float64)
    deg = np.asarray(er.sum(axis=1)).ravel()
    gl = sp.diags(deg) - er
    ro = rcm_reorder(gl, device=device)
    out["graph_er_rcm"] = fin(gl[ro.perm][:, ro.perm])

    pts = rng.random((n, 2))
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    pairs = tree.query_pairs(0.06 if not small else 0.12, output_type="ndarray")
    adj = sp.csr_matrix(
        (np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n)
    )
    adj = adj + adj.T
    geo = sp.diags(np.asarray(adj.sum(axis=1)).ravel() + 0.1) - adj
    ro = rcm_reorder(geo, device=device)
    out["graph_geometric_rcm"] = fin(geo[ro.perm][:, ro.perm])

    # -- nos*-like SPD normal equations
    b = sp.random(n, n, density=4.0 / n, random_state=3)
    out["spd_normal_eq"] = fin((b.T @ b) + 0.1 * sp.eye(n))

    # -- finan512-like: ring of dense-ish blocks
    nb, bsz = (16, 16) if small else (25, 40)
    blocks = []
    for _ in range(nb):
        m = rng.standard_normal((bsz, bsz)) * 0.2
        blocks.append(m @ m.T + np.eye(bsz))
    fin_ring = sp.block_diag(blocks).tolil()
    for k in range(nb):
        a0, b0 = k * bsz, ((k + 1) % nb) * bsz
        fin_ring[a0, b0] = fin_ring[b0, a0] = -0.5
    out["finan_blockring"] = fin(fin_ring)

    # -- wathen-like random-element 2-D FEM assembly
    ge = 10 if small else 20
    nw = (ge + 1) ** 2
    wm = sp.lil_matrix((nw, nw))
    for ex in range(ge):
        for ey in range(ge):
            nodes = [
                ex * (ge + 1) + ey,
                ex * (ge + 1) + ey + 1,
                (ex + 1) * (ge + 1) + ey,
                (ex + 1) * (ge + 1) + ey + 1,
            ]
            e = rng.random() * (np.eye(4) * 2.0 + 1.0)
            for ii in range(4):
                for jj in range(4):
                    wm[nodes[ii], nodes[jj]] += e[ii, jj]
    out["wathen_fem"] = fin(wm)

    # -- periodic ring (circulant; the runLanczos wrap structure)
    ring = _lap1d(n).tolil()
    ring[0, n - 1] = ring[n - 1, 0] = -1.0
    out["ring_periodic"] = fin(ring)

    return out
