"""The open transverse-field Ising chain of L spins with a longitudinal
field on its first spin (Pfeuty, Ann. Phys. 57, 79 (1970)), as A = -H in
the sigma^z basis:

    A = J sum_{i=1}^{L-1} Z_i Z_{i+1} + b Z_1 + h sum_{i=1}^{L} X_i.

Bit i - 1 of a row index is spin i (bit 0: Z = +1), so n = 2^L and the
spin flip X_i couples rows r and r ^ 2^(i-1).  The largest eigenvalues of
A are the lowest levels of H.  The field b breaks the spin flip and the
reflection, both of which fix the vector of ones; the chain stays
exactly solvable (``reference/tfim_free_fermion.py``).  Every row stores
its diagonal, as a zero where the bonds and the field cancel, so it holds
L + 1 entries and nnz = (L + 1) n.  The model has no disorder: the seed
is not used.
"""

import numpy as np
import scipy.sparse as sp


def spins(n: int) -> int:
    """L for n = 2^L rows; raises unless n is a power of two."""
    if n < 4 or n & (n - 1):
        raise ValueError(f"the chain has 2^L rows, not {n}")
    return n.bit_length() - 1


def diagonal(L: int, J: float, b: float) -> np.ndarray:
    """J sum_i Z_i Z_{i+1} + b Z_1 on every basis state, f64."""
    r = np.arange(1 << L, dtype=np.int64)

    def z(i):  # Z_i, i = 1..L
        return 1.0 - 2.0 * ((r >> (i - 1)) & 1)

    d = b * z(1)
    for i in range(1, L):
        d += J * z(i) * z(i + 1)
    return d


def build(n: int, seed: int, J: float, h: float, b: float) -> sp.csr_matrix:
    """The chain on n = 2^L rows, f64 CSR with sorted indices."""
    del seed  # no disorder
    L = spins(n)
    r = np.arange(n, dtype=np.int32)
    cols = np.empty((n, L + 1), np.int32)
    cols[:, 0] = r
    cols[:, 1:] = r[:, None] ^ (np.int32(1) << np.arange(L, dtype=np.int32))
    cols.sort(axis=1)
    # the columns below r are r less one of its set bits: r sits at its popcount
    ones = np.zeros(n, np.int64)
    for i in range(L):
        ones += (r >> i) & 1
    vals = np.full((n, L + 1), float(h))
    vals[np.arange(n), ones] = diagonal(L, J, b)
    indptr = np.arange(0, n * (L + 1) + 1, L + 1, dtype=np.int64)
    a = sp.csr_matrix((vals.ravel(), cols.ravel(), indptr), shape=(n, n))
    a.has_sorted_indices = True
    return a
