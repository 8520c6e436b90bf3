"""Plain reference for the largest eigenpairs of the open transverse-field
Ising chain with a field on its first spin (``matrices/tfim_chain.py``),
by free fermions.

It reads the matrix as the program was handed it (the benchmark rebuilds
it from the seed), in f64 NumPy/SciPy, and imports nothing of the
program.  The certificate that it is the model: n = 2^L; every row r
holds its diagonal and h at the L columns r ^ 2^i, with one |h| and signs
s_r s_c of a gauge s = +-1 (S A S); the diagonal is J sum Z_i Z_{i+1} +
b Z_1 for the J and b read off three rows.  A matrix that fails raises:
there is no reference.

The levels (Pfeuty, Ann. Phys. 57, 79 (1970); Lieb, Schultz and Mattis,
Ann. Phys. 16, 407 (1961)): the chain with the field b on spin 1 is one
Z_0 sector of an (L+1)-site chain whose extra spin 0 has no transverse
field and couples to spin 1 with strength b.  Its quasiparticle energies
Lambda are twice the singular values of the (L+1) x (L+1) upper
bidiagonal matrix with diagonal (0, h, ..., h) and superdiagonal (b, J,
..., J), the zero mode dropped; every level of A is
1/2 sum Lambda - sum_{occupied} Lambda, over all 2^L occupations.  The
reference enumerates up to three quasiparticles and certifies that the
levels it keeps lie above every level with four or more.

An answer is judged by two numbers, both relative:

* ``eig_err``: max_j |lambda_j - theta_j| / theta_1 over the k wanted
  values, both sorted descending;
* ``vec_err``: max_j ||A q_j - rho_j q_j|| / delta_j, in f64 with the
  reference's own matrix: q_j the returned vector (paired with its value
  by rank) normalised, rho_j its Rayleigh quotient, delta_j the distance
  from rho_j to the nearest other exact level (Davis and Kahan's bound on
  sin(q_j, v_j)).  The vectors are spread over all rows, so an answer
  keeps every row (``keep_rows``).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as sla

MAX_QP = 3  # quasiparticles enumerated
# ARPACK's residual bound relative to |theta|: vectors within ~1e-6 of the
# exact ones at the smallest gap, far below the control's TF32 rounding
EIGSH_TOL = 1e-9


@dataclasses.dataclass
class Reference:
    theta: np.ndarray  # (k,) desc, the k largest eigenvalues of A
    levels: np.ndarray  # (m,) desc, every level above ``tau``, certified
    tau: float  # bound on every other level
    a: sp.csr_matrix  # the matrix, f64


def _model(a: sp.csr_matrix):
    """(L, J, h, b) of the chain ``a`` in any gauge; raises unless ``a`` is it."""
    n = a.shape[0]
    if n < 8 or n & (n - 1) or a.shape[1] != n:
        raise ValueError("reference: no certificate (not 2^L rows)")
    L = n.bit_length() - 1
    counts = np.diff(a.indptr)
    if np.any(counts != L + 1):
        raise ValueError("reference: no certificate (a row does not hold L + 1 entries)")
    rows = np.repeat(np.arange(n, dtype=np.int64), L + 1)
    cols = a.indices.astype(np.int64)
    x = rows ^ cols
    # L + 1 distinct columns a row, each r or r with one spin flipped: all of them
    if (np.any(x & (x - 1)) or cols.min() < 0 or cols.max() >= n
            or np.any(np.diff(cols.reshape(n, L + 1), axis=1) <= 0)):
        raise ValueError("reference: no certificate (entries off the spin flips)")
    on = x == 0
    off = a.data[~on]
    h = float(np.abs(off[0]))
    if h <= 0 or np.any(np.abs(off) != h):
        raise ValueError("reference: no certificate (not one transverse field |h|)")
    # the gauge: s_0 = 1, s_r = s_c sign A[r, c] for c = r less its top bit
    top = np.zeros(n, np.int64)
    for i in range(L):
        top[1 << i:] = 1 << i
    down = cols == rows - top[rows]
    down &= rows > 0
    sign = np.ones(n)
    sign[rows[down]] = np.sign(a.data[down])
    s = np.ones(n)
    for i in range(L):
        lo = 1 << i
        s[lo:2 * lo] = s[:lo] * sign[lo:2 * lo]
    if not np.array_equal(np.sign(off), s[rows[~on]] * s[cols[~on]]):
        raise ValueError("reference: no certificate (the signs are not a gauge)")
    d = a.diagonal()
    J = (d[0] - d[2]) / 4.0
    b = d[0] - J * (L - 1)
    r = np.arange(n, dtype=np.int64)
    expect = b * (1.0 - 2.0 * (r & 1))
    for i in range(1, L):
        expect += J * (1.0 - 2.0 * ((r >> (i - 1)) & 1)) * (1.0 - 2.0 * ((r >> i) & 1))
    if not np.array_equal(d, expect):
        raise ValueError("reference: no certificate (the diagonal is not J ZZ + b Z_1)")
    return L, float(J), h, float(b)


def quasiparticles(L: int, J: float, h: float, b: float) -> np.ndarray:
    """The L quasiparticle energies Lambda, ascending."""
    B = np.diag(np.concatenate([[0.0], np.full(L, h)]))
    B[0, 1] = b
    B[np.arange(1, L), np.arange(2, L + 1)] = J
    sv = np.sort(2.0 * np.linalg.svd(B, compute_uv=False))
    return sv[1:]  # the zero mode: Z_0 is conserved


def levels(L: int, J: float, h: float, b: float, max_qp: int = MAX_QP):
    """(levels with at most ``max_qp`` quasiparticles, desc; the largest
    level with more)."""
    lam = quasiparticles(L, J, h, b)
    top = 0.5 * lam.sum()
    out = [top - sum(c) for q in range(max_qp + 1)
           for c in itertools.combinations(lam, q)]
    above = top - lam[:max_qp + 1].sum() if L > max_qp else -np.inf
    return np.sort(out)[::-1], float(above)


def keep_rows(a) -> np.ndarray:
    """The rows of every answer that the judge reads: all of them."""
    return np.arange(a.shape[0])


def top_pairs(a, k: int) -> Reference:
    """The k largest eigenvalues of the chain ``a``, certified, and the
    matrix the judge applies."""
    a = sp.csr_matrix(a, dtype=np.float64)
    a.sort_indices()
    L, J, h, b = _model(a)
    lv, above = levels(L, J, h, b)
    certain = lv[lv > above]
    if certain.size < k + 3:
        raise ValueError(f"reference: no certificate ({certain.size} levels above every "
                         f"level of {MAX_QP + 1} or more quasiparticles, {k + 3} needed)")
    tau = max(above, float(lv[certain.size]) if lv.size > certain.size else -np.inf)
    return Reference(theta=certain[:k], levels=certain, tau=tau, a=a)


def judge(ref: Reference, eigs, kept, out_sq) -> dict:
    """``eig_err`` and ``vec_err`` of one answer: its values ``eigs`` (k',),
    its vectors' rows (``kept``, (n, k'): every row) and the sums of
    squares of their other rows ``out_sq`` (k', nought), all aligned.
    inf where the answer lacks a pair or holds a non-finite number."""
    k = len(ref.theta)
    n = ref.a.shape[0]
    eigs = np.asarray(eigs, np.float64).ravel()
    bad = {"eig_err": np.inf, "vec_err": np.inf}
    if kept is None or out_sq is None:
        return bad
    kept = np.asarray(kept, np.float64)
    out_sq = np.asarray(out_sq, np.float64).ravel()
    if (eigs.shape[0] < k or kept.ndim != 2 or kept.shape != (n, eigs.shape[0])
            or out_sq.shape != eigs.shape):
        return bad
    order = np.argsort(-eigs, kind="stable")[:k]
    e, Q = eigs[order], kept[:, order]
    if not (np.all(np.isfinite(e)) and np.all(np.isfinite(Q))
            and np.all(np.isfinite(out_sq)) and np.all(out_sq[order] == 0)):
        return bad
    eig_err = float(np.max(np.abs(e - ref.theta)) / abs(ref.theta[0]))
    norms = np.linalg.norm(Q, axis=0)
    if np.any(norms == 0):
        return bad
    Q = Q / norms
    AQ = ref.a @ Q
    rho = np.sum(Q * AQ, axis=0)
    resid = np.linalg.norm(AQ - Q * rho, axis=0)
    worst = 0.0
    for j in range(k):
        others = np.delete(ref.levels, j)
        delta = min(float(np.min(np.abs(others - rho[j]))), rho[j] - ref.tau)
        worst = max(worst, resid[j] / delta if delta > 0 else np.inf)
    return {"eig_err": eig_err, "vec_err": float(worst)}


def tf32_round(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _round(p: str):
    if p == "float32":
        return lambda x: np.asarray(x, np.float32)
    if p == "tf32":
        return tf32_round
    raise ValueError(f"no control below {p!r}")


def control_answer(a, k: int, eig_precision: str, vec_precision: str):
    """The reference in the program's place at lower precisions: (eigs (k,),
    every row of the vectors (n, k) as float32, rows).  The values are the
    exact levels, the vectors ARPACK's (``eigsh`` in f64), each rounded to
    the precision the control computes that output in ("float32" or
    "tf32")."""
    a = sp.csr_matrix(a, dtype=np.float64)
    ref = top_pairs(a, k)
    eigs = _round(eig_precision)(ref.theta).astype(np.float64)
    rnd = _round(vec_precision)
    w, V = sla.eigsh(a, k=k, which="LA", ncv=max(4 * k, 40), tol=EIGSH_TOL,
                     v0=np.random.default_rng(0).standard_normal(a.shape[0]))
    V = V[:, np.argsort(-w)]
    return eigs, rnd(V.astype(np.float32)), keep_rows(a)


# the precision one step below each precision an answer can state
BELOW = {"float64": "float32", "float32": "tf32"}
