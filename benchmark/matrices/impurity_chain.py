"""A tight-binding chain with on-site impurities (Koster and Slater, Phys.
Rev. 95, 1167 (1954)): H = t sum_i (|i><i+1| + |i+1><i|) + sum_j eps_j |x_j><x_j|.

The clean chain's spectrum is the band (-2t, 2t); each repulsive impurity
(eps_j > 0) binds one level above it.  The run's seed places the
impurities: it draws ``len(eps)`` of the ``slots`` equal stretches of the
chain, not the first or the last, puts one impurity in the middle half of
each, and deals the strengths out in a random order.  Every seed so gives
the same spectrum (the same work) on a different matrix (other vectors).
"""

import numpy as np
import scipy.sparse as sp


def sites(n: int, seed: int, eps, slots: int):
    """(rows, strengths) of the impurities for the seed."""
    rng = np.random.default_rng(seed & (2**64 - 1))
    k = len(eps)
    slot = n // slots
    if slots < k + 2 or slot < 8:
        raise ValueError(f"{k} impurities do not fit {slots} slots of {slot} rows")
    chosen = rng.choice(np.arange(1, slots - 1), size=k, replace=False)
    rows = chosen * slot + rng.integers(slot // 4, 3 * slot // 4, size=k)
    return rows.astype(np.int64), np.asarray(eps, np.float64)[rng.permutation(k)]


def build(n: int, seed: int, hopping: float, eps, slots: int) -> sp.csr_matrix:
    """The chain for the seed, f64 CSR with sorted indices: 2(n - 1) hops
    and one diagonal entry per impurity."""
    rows, vals = sites(n, seed, eps, slots)
    counts = np.full(n, 2, np.int64)
    counts[[0, -1]] = 1
    counts[rows] += 1
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = np.empty(indptr[-1], np.int64)
    data = np.full(indptr[-1], float(hopping))
    i = np.arange(n)
    lo = indptr[:-1]
    # each row: its left neighbour, its impurity (if any), its right neighbour
    has_left = i > 0
    indices[lo[has_left]] = i[has_left] - 1
    mid = lo + has_left
    indices[mid[rows]] = rows
    data[mid[rows]] = vals
    right = indptr[1:] - 1
    has_right = i < n - 1
    indices[right[has_right]] = i[has_right] + 1
    a = sp.csr_matrix((data, indices.astype(np.int32), indptr), shape=(n, n))
    a.has_sorted_indices = True
    return a
