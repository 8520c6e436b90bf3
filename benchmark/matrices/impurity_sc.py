"""A periodic simple-cubic tight-binding lattice with deep on-site
impurities (Koster and Slater, Phys. Rev. 95, 1167 (1954)):

    H = t sum_<ij> (|i><j| + |j><i|) + sum_j eps_j |r_j><r_j|

on an L x L x L lattice with periodic boundaries, row x + L y + L^2 z.
The clean lattice's spectrum is [-6t, 6t]; an impurity with eps_j above
the binding threshold (1 / G(6) = 3.9568 t, Watson's integral) binds one
level above 6t.  The seed places the impurities: it draws ``len(eps)`` of
the ``cells``^3 cells of a cells x cells x cells partition, puts one
impurity in the middle half of each drawn cell along every axis, and
deals the strengths out in a random order.  Every seed so gives nearly
the same spectrum on a different matrix (other vectors).
"""

import numpy as np
import scipy.sparse as sp


def side(n: int) -> int:
    """L for n = L^3 rows; raises unless n is the cube of some L >= 3."""
    L = int(round(n ** (1.0 / 3.0)))
    L = next((m for m in (L - 1, L, L + 1) if m ** 3 == n), 0)
    if L < 3:
        raise ValueError(f"the lattice has L^3 rows, L >= 3, not {n}")
    return L


def sites(L: int, seed: int, eps, cells: int):
    """(rows, strengths) of the impurities for the seed."""
    rng = np.random.default_rng(seed & (2**64 - 1))
    k = len(eps)
    c = L // cells
    if cells ** 3 < k or c < 4:
        raise ValueError(f"{k} impurities do not fit {cells}^3 cells of {c} sites a side")
    chosen = rng.choice(cells ** 3, size=k, replace=False)
    cell = np.stack(np.unravel_index(chosen, (cells,) * 3), axis=1)  # (k, 3): z, y, x
    z, y, x = (cell * c + rng.integers(c // 4, 3 * c // 4, size=(k, 3))).T
    rows = x + L * y + L * L * z
    return rows.astype(np.int64), np.asarray(eps, np.float64)[rng.permutation(k)]


def build(n: int, seed: int, hopping: float, eps, cells: int) -> sp.csr_matrix:
    """The lattice for the seed, f64 CSR with sorted indices: six periodic
    hops a row and one diagonal entry per impurity, 6 n + len(eps) entries."""
    L = side(n)
    rows, vals = sites(L, seed, eps, cells)
    r = np.arange(n, dtype=np.int64)
    cols = np.empty((n, 7), np.int64)
    cols[:, 6] = r
    for a, step in enumerate((1, L, L * L)):
        coord = r // step % L
        cols[:, 2 * a] = r + np.where(coord == L - 1, step * (1 - L), step)
        cols[:, 2 * a + 1] = r + np.where(coord == 0, step * (L - 1), -step)
    cols.sort(axis=1)
    keep = cols != r[:, None]
    keep[rows] = True
    counts = keep.sum(axis=1)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    idx_dtype = np.int32 if indptr[-1] < 2**31 else np.int64
    indices = cols[keep].astype(idx_dtype)
    data = np.full(indices.size, float(hopping))
    data[indptr[rows] + np.sum(cols[rows] < rows[:, None], axis=1)] = vals
    a = sp.csr_matrix((data, indices, indptr.astype(idx_dtype)), shape=(n, n))
    a.has_sorted_indices = True
    return a
