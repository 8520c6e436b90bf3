"""Plain reference for the largest eigenpairs of a tight-binding chain with
on-site impurities (``matrices/impurity_chain.py``), in closed form.

It reads the matrix as the program was handed it (the benchmark rebuilds
it from the seed), in f64 NumPy, and imports nothing of the program: the
hop t, whose size every off-diagonal entry has to hold, its signs, which
make the matrix S A S for a gauge s = +-1 (s_0 = 1, s_{i+1} = s_i sign
A[i, i+1]) of a chain A with hop +t, and the impurities, the nonzero
diagonal entries eps_j > 0.  One impurity in an infinite chain binds one
level above the band (Koster and Slater, Phys. Rev. 95, 1167 (1954)):

    E = sqrt(eps^2 + 4 t^2),  v(x) = c r^|x - x_j| s_x,
    r = (E - eps) / (2t),     c^2 = (1 - r^2) / (1 + r^2).

Cut to the window |x - x_j| <= W, with r^W < 1e-20, the pair is one of
the finite matrix up to the residual that the reference computes from
the matrix's own rows.  The certificate: A less its m positive diagonal
entries is the clean chain, whose largest eigenvalue 2t cos(pi / (n+1))
is below 2t, so A has at most m eigenvalues above 2t (interlacing); when
the intervals E_j +- ||r_j|| are disjoint and above 2t they hold exactly
those, in order.  A matrix that fails it raises: there is no reference.

An answer is judged by two numbers, both relative:

* ``eig_err``: max_j |lambda_j - theta_j| / |theta_1| over the k wanted
  values, both sorted descending;
* ``vec_err``: max_j ||q_j - sign_j v_j||, the distance of each returned
  vector (paired with its value by rank) from the reference's unit
  vector.  v_j is nought outside its window, so the distance needs only
  the answer's rows on the windows (``keep_rows``) and the sum of squares
  of its other rows, which the harness keeps of every answer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

CUT = 1e-20  # a vector's amplitude at the edge of its window, at most


@dataclasses.dataclass
class Reference:
    theta: np.ndarray  # (k,) desc, the k largest eigenvalues of A
    site: np.ndarray  # (k,) the impurity row of each
    r: np.ndarray  # (k,) decay ratio per row
    half: np.ndarray  # (k,) window half-width W
    rows: np.ndarray  # sorted rows of all the windows: what an answer keeps
    gauge: np.ndarray  # s on ``rows``
    resid: np.ndarray  # (k,) ||A v_j - theta_j v_j||, the certificate's radii
    tau: float  # bound on every other eigenvalue


def _levels(a: sp.csr_matrix):
    """(t, gauge, sites, eps, E, r, W) of the chain ``a``, levels in
    descending order."""
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
    off = a.indices.astype(np.int64) - rows
    up, down = a.data[off == 1], a.data[off == -1]  # A[i, i+1] and A[i+1, i], by i
    hops = np.abs(up)
    if (np.any(np.abs(off) > 1) or up.size != n - 1 or down.size != n - 1
            or not np.array_equal(up, down) or np.ptp(hops) != 0 or hops[0] <= 0):
        raise ValueError("reference: no certificate (not a symmetric chain with one hop |t|)")
    t = float(hops[0])
    gauge = np.concatenate([[1.0], np.cumprod(np.sign(up))])
    on = off == 0
    sites, eps = rows[on], a.data[on]
    keep = eps != 0
    sites, eps = sites[keep], eps[keep]
    if np.any(eps < 0) or sites.size == 0:
        raise ValueError("reference: no certificate (needs repulsive impurities, eps > 0)")
    E = np.sqrt(eps * eps + 4 * t * t)
    r = (E - eps) / (2 * t)
    W = np.ceil(np.log(CUT) / np.log(r)).astype(np.int64)
    order = np.argsort(-E, kind="stable")
    return t, gauge, sites[order], eps[order], E[order], r[order], W[order]


def _windows(sites, W):
    return [np.arange(x - w, x + w + 1) for x, w in zip(sites, W)]


def keep_rows(a) -> np.ndarray:
    """The rows of every answer that the judge reads: all the windows."""
    a = sp.csr_matrix(a, dtype=np.float64)
    _, _, sites, _, _, _, W = _levels(a)
    return np.unique(np.concatenate(_windows(sites, W)))


def unit_vector(r: float, half: int, dtype=np.float64) -> np.ndarray:
    """c r^|d| on d = -half..half, computed in ``dtype``."""
    r = dtype(r)
    d = np.abs(np.arange(-half, half + 1)).astype(dtype)
    c = np.sqrt((dtype(1) - r * r) / (dtype(1) + r * r))
    return (c * r ** d).astype(dtype)


def top_pairs(a, k: int) -> Reference:
    """The k largest eigenpairs of the chain ``a``, certified."""
    a = sp.csr_matrix(a, dtype=np.float64)
    n = a.shape[0]
    t, gauge, sites, _, E, r, W = _levels(a)
    if sites.size < k:
        raise ValueError(f"reference: no certificate ({sites.size} levels above the band, "
                         f"{k} wanted)")
    win = _windows(sites, W)
    edges = np.concatenate([[x - w - 1, x + w + 1] for x, w in zip(sites, W)])
    if edges.min() < 0 or edges.max() > n - 1:
        raise ValueError("reference: no certificate (a window meets the end of the chain)")
    spans = sorted(zip(sites - W - 1, sites + W + 1))
    if any(lo <= hi for (_, hi), (lo, _) in zip(spans, spans[1:])):
        raise ValueError("reference: no certificate (two impurities' windows meet)")
    resid = np.empty(sites.size)
    for j, (x, w) in enumerate(zip(sites, W)):
        lo, hi = x - w - 1, x + w + 2  # the window and one row each side
        v = np.zeros(hi - lo)
        v[1:-1] = unit_vector(r[j], int(w)) * gauge[x - w:x + w + 1]
        Av = a[lo:hi, lo:hi] @ v  # rows outside [lo, hi) meet only zeros of v
        resid[j] = np.linalg.norm(Av - E[j] * v)
    tau = 2 * t
    lo_end = E - resid
    if not (np.all(lo_end > tau) and np.all(lo_end[:-1] > E[1:] + resid[1:])):
        raise ValueError(f"reference: no certificate (levels {E.tolist()}, radii "
                         f"{resid.tolist()}, band edge {tau})")
    rows = np.unique(np.concatenate(win))
    return Reference(theta=E[:k], site=sites[:k], r=r[:k], half=W[:k], rows=rows,
                     gauge=gauge[rows], resid=resid[:k],
                     tau=float(max(tau, E[k]) if sites.size > k else tau))


def judge(ref: Reference, eigs, kept, out_sq) -> dict:
    """``eig_err`` and ``vec_err`` of one answer: its values ``eigs`` (k',),
    its vectors' rows ``ref.rows`` (``kept``, (len(rows), k')) and the
    sums of squares of their other rows ``out_sq`` (k',), all aligned.
    inf where the answer lacks a pair or holds a non-finite number."""
    k = len(ref.theta)
    eigs = np.asarray(eigs, np.float64).ravel()
    kept = np.asarray(kept, np.float64)
    out_sq = np.asarray(out_sq, np.float64).ravel()
    bad = {"eig_err": np.inf, "vec_err": np.inf}
    if (eigs.shape[0] < k or kept.ndim != 2 or kept.shape != (ref.rows.size, eigs.shape[0])
            or out_sq.shape != eigs.shape):
        return bad
    order = np.argsort(-eigs, kind="stable")[:k]
    e, K, o = eigs[order], kept[:, order], out_sq[order]
    if not (np.all(np.isfinite(e)) and np.all(np.isfinite(K)) and np.all(np.isfinite(o))):
        return bad
    eig_err = float(np.max(np.abs(e - ref.theta)) / abs(ref.theta[0]))
    worst = 0.0
    for j in range(k):
        at = np.searchsorted(ref.rows, np.arange(ref.site[j] - ref.half[j],
                                                 ref.site[j] + ref.half[j] + 1))
        v = unit_vector(ref.r[j], int(ref.half[j])) * ref.gauge[at]
        q = K[at, j]
        sign = -1.0 if q @ v < 0 else 1.0
        outside = np.ones(ref.rows.size, bool)
        outside[at] = False  # kept rows of the other windows
        worst = max(worst, float(np.sum((q - sign * v) ** 2) + np.sum(K[outside, j] ** 2)
                                 + o[j]))
    return {"eig_err": eig_err, "vec_err": float(np.sqrt(worst))}


def tf32_round(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def control_answer(a, k: int, eig_precision: str, vec_precision: str):
    """The reference in the program's place at lower precisions: (eigs (k,),
    the vectors' rows ``keep_rows(a)`` (len(rows), k) as float32, rows).
    ``*_precision`` is the precision the control computes that output in
    ("float32" or "tf32")."""
    a = sp.csr_matrix(a, dtype=np.float64)
    t, gauge, sites, eps, _, _, W = _levels(a)
    rows = keep_rows(a)

    def level(p):
        if p not in ("float32", "tf32"):
            raise ValueError(f"no control below {p!r}")
        rnd = tf32_round if p == "tf32" else (lambda x: np.asarray(x, np.float32))
        e32, t32 = rnd(eps[:k]), rnd(np.full(k, t))
        E = rnd(np.sqrt(rnd(e32 * e32 + rnd(4 * t32 * t32))))
        return E, rnd, rnd((E - e32) / rnd(2 * t32))

    eigs = level(eig_precision)[0].astype(np.float64)
    _, rnd, r = level(vec_precision)
    V = np.zeros((rows.size, k), np.float32)
    for j in range(k):
        at = np.searchsorted(rows, np.arange(sites[j] - W[j], sites[j] + W[j] + 1))
        V[at, j] = rnd(unit_vector(r[j], int(W[j]), np.float32)) * gauge[rows[at]]
    return eigs, V, rows


# the precision one step below each precision an answer can state
BELOW = {"float64": "float32", "float32": "tf32"}
