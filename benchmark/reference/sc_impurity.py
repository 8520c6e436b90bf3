"""Plain reference for the largest eigenpairs of a periodic simple-cubic
lattice with deep on-site impurities (``matrices/impurity_sc.py``), by the
lattice Green's function.

It reads the matrix as the program was handed it (the benchmark rebuilds
it from the seed), in f64 NumPy/SciPy, and imports nothing of the
program.  The model it checks: n = L^3 rows, row x + L y + L^2 z; every
row holds its six periodic neighbours, one hop |t| with the signs s_r s_c
of a gauge s = +-1 (S A S), and a diagonal entry only at the impurities,
eps_j > 0.  A matrix that fails raises: there is no reference.

The levels.  With H0 the clean lattice (t times the adjacency) and R the
impurity rows, A = S (H0 + P D P^T) S.  For E above H0's spectrum, let
G0(E) = (E - H0)^-1 and M(E) = G0(E)_RR - D^-1.  By Haynsworth's inertia
additivity the number of eigenvalues of A above E is the number of
positive eigenvalues of M(E); every eigenvalue of M falls as E grows, so
the j-th largest level is the root of M's j-th largest eigenvalue, and
its vector is S G0(E) P c, c the null vector of M(E).  G0 is summed in
closed form over z and exactly over the (k_x, k_y) grid:

    G0(d) = 1/(t L^2) sum_{k_x, k_y} cos(k_x d_x) cos(k_y d_y) g(d_z; a),
    a = E/t - 2 cos k_x - 2 cos k_y = 2 cosh mu,
    g(d; a) = (1/L) sum_{k_z} cos(k_z d) / (a - 2 cos k_z)
            = (e^{-mu d} + e^{-mu (L - d)}) / (2 sinh mu (1 - e^{-mu L})).

A level's vector is kept on cubes around the impurities, each as wide as
bounds the vector's norm outside all of them by ``CUT`` (the tail of
G0(E)^2 beyond each cube, summed exactly over the lattice).  The
certificate: A less its m positive diagonal entries is the clean lattice,
whose largest eigenvalue is exactly 6t, so A has at most m eigenvalues
above 6t (interlacing); the residual ||A u_j - E_j u_j|| / ||u_j|| of each
kept vector, computed on A's own rows, bounds the distance to an
eigenvalue, so when the m intervals E_j +- that radius are disjoint and
above 6t they hold exactly A's m largest eigenvalues, in order.

An answer is judged by two numbers, both relative:

* ``eig_err``: max_j |lambda_j - theta_j| / |theta_1| over the k wanted
  values, both sorted descending;
* ``vec_err``: max_j ||q_j - sign_j v_j||, the distance of each returned
  vector (paired with its value by rank) from the reference's unit
  vector, on the kept rows (``keep_rows``: every wanted level's cubes)
  plus the sum of squares of the answer's other rows, which the harness
  keeps of every answer.  v_j is below ``CUT`` in norm off those rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.optimize
import scipy.sparse as sp

CUT = 1e-10  # a vector's norm off its kept rows, at most, relative
TAIL = 1e-3 * CUT  # an impurity's share of a vector below this is left out


@dataclasses.dataclass
class Reference:
    theta: np.ndarray  # (k,) desc, the k largest eigenvalues of A
    levels: np.ndarray  # (m,) desc, all m levels above 6t
    rows: np.ndarray  # sorted rows of the wanted levels' cubes: what an answer keeps
    vecs: np.ndarray  # (len(rows), k) the unit vectors on ``rows``, in the matrix's gauge
    resid: np.ndarray  # (m,) the certificate's radii
    tau: float  # bound on every other eigenvalue


def _side(n: int) -> int:
    L = int(round(n ** (1.0 / 3.0)))
    L = next((m for m in (L - 1, L, L + 1) if m ** 3 == n), 0)
    if L < 3:
        raise ValueError("reference: no certificate (not L^3 rows, L >= 3)")
    return L


def _neighbours(L: int, r: np.ndarray) -> np.ndarray:
    """(len(r), 6) the periodic neighbours +x, -x, +y, -y, +z, -z of rows r."""
    out = np.empty((r.size, 6), np.int64)
    for a, step in enumerate((1, L, L * L)):
        c = r // step % L
        out[:, 2 * a] = r + np.where(c == L - 1, step * (1 - L), step)
        out[:, 2 * a + 1] = r + np.where(c == 0, step * (L - 1), -step)
    return out


def _model(a: sp.csr_matrix):
    """(L, t, gauge s (n,) int8, impurity rows, eps) of the lattice ``a``
    in any gauge; raises unless ``a`` is it."""
    n = a.shape[0]
    L = _side(n)
    if a.shape[1] != n:
        raise ValueError("reference: no certificate (not square)")
    counts = np.diff(a.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    on = a.indices == rows
    has = np.zeros(n, bool)
    has[rows[on]] = True
    del rows
    if np.any(counts - has != 6):
        raise ValueError("reference: no certificate (a row does not hold six hops)")
    # the six hops of each row, in column order, against the periodic neighbours
    nb = _neighbours(L, np.arange(n, dtype=np.int64))
    order = np.argsort(nb, axis=1, kind="stable")
    cols = a.indices[~on].reshape(n, 6)
    if not np.array_equal(cols, np.take_along_axis(nb, order, axis=1)):
        raise ValueError("reference: no certificate (the hops are not the periodic lattice's)")
    del cols
    hop = a.data[~on].reshape(n, 6)
    t = float(abs(hop[0, 0]))
    if t <= 0 or np.any(np.abs(hop) != t):
        raise ValueError("reference: no certificate (not one hop |t|)")
    sign = np.empty((n, 6), np.int8)  # sign of each hop, by direction
    np.put_along_axis(sign, order, np.sign(hop).astype(np.int8), axis=1)
    del hop, order
    # the gauge: s = 1 at the origin, then along x, y, z by the + hops
    px, py, pz = (sign[:, d].reshape(L, L, L) for d in (0, 2, 4))  # [z, y, x]
    s = np.ones((L, L, L), np.int8)
    s[0, 0, 1:] = np.cumprod(px[0, 0, :-1])
    s[0, 1:, :] = s[0, 0, :] * np.cumprod(py[0, :-1, :], axis=0)
    s[1:] = s[0] * np.cumprod(pz[:-1], axis=0)
    s = s.reshape(n)
    if not np.array_equal(sign, s[:, None] * s[nb]):
        raise ValueError("reference: no certificate (the signs are not a gauge)")
    sites = np.flatnonzero(has)
    eps = a.data[on]
    keep = eps != 0
    sites, eps = sites[keep], eps[keep]
    if sites.size == 0 or np.any(eps < 0):
        raise ValueError("reference: no certificate (needs repulsive impurities, eps > 0)")
    return L, t, s, sites, eps


class _Green:
    """G0(E)(d) of the L^3 lattice with hop 1, at E = e, by the closed
    form over z and the exact sum over half the (k_x, k_y) grid."""

    def __init__(self, L: int):
        self.L = L
        m = np.arange(L // 2 + 1)
        self.k = 2 * np.pi * m / L
        self.w = np.where((m == 0) | (2 * m == L), 1.0, 2.0) / L
        c2 = 2 * np.cos(self.k)
        self.c2 = c2[:, None] + c2[None, :]

    def _g(self, dz: np.ndarray, e: float, deriv: bool):
        """(len(dz), h, h) g(d_z; a) over the grid, or its a-derivative."""
        a = e - self.c2
        if np.any(a <= 2):
            raise ValueError("reference: no certificate (E inside the clean band)")
        mu = np.arccosh(a / 2)[None]
        sh = np.sinh(mu)
        L = self.L
        d = np.asarray(dz, np.float64)[:, None, None]
        p, q, qL = np.exp(-mu * d), np.exp(-mu * (L - d)), np.exp(-mu * L)
        num, den = p + q, 2 * sh * (1 - qL)
        if not deriv:
            return num / den
        dnum = -d * p - (L - d) * q
        dden = 2 * np.cosh(mu) * (1 - qL) + 2 * sh * L * qL
        return (dnum * den - num * dden) / (den * den) / (2 * sh)

    def at(self, e: float, disp: np.ndarray, deriv: bool = False) -> np.ndarray:
        """G0 (or dG0/dE) at the displacements ``disp`` (P, 3): x, y, z."""
        dz, u = np.unique(disp[:, 2], return_inverse=True)
        g = self._g(dz, e, deriv)[u]
        cx = self.w[None] * np.cos(self.k[None] * disp[:, :1])
        cy = self.w[None] * np.cos(self.k[None] * disp[:, 1:2])
        return np.einsum("pm,pn,pmn->p", cx, cy, g)

    def table(self, e: float) -> np.ndarray:
        """(L//2 + 1, L, L) G0 at every displacement [d_z, d_x, d_y], d_z
        folded to 0..L//2."""
        g = self._g(np.arange(self.L // 2 + 1), e, False)
        d = np.arange(self.L)
        c = np.cos(np.outer(d, self.k)) * self.w[None]  # (L, h)
        return c[None] @ g @ c.T[None]


def _fold(d: np.ndarray, L: int) -> np.ndarray:
    d = np.mod(d, L)
    return np.minimum(d, L - d)


def _coords(rows: np.ndarray, L: int) -> np.ndarray:
    return np.stack([rows % L, rows // L % L, rows // (L * L)], axis=1)


class _Levels:
    """The m levels of the model (L, t, sites, eps), in units of t: each
    E_j, the null vector c_j of M(E_j), and the norm of G0(E_j) P c_j."""

    def __init__(self, L: int, t: float, sites: np.ndarray, eps: np.ndarray):
        self.L, self.sites = L, sites
        self.xyz = _coords(sites, L)
        self.green = _Green(L)
        m = sites.size
        disp = _fold(self.xyz[:, None, :] - self.xyz[None, :, :], L).reshape(m * m, 3)
        self.disp, self.pair = np.unique(disp, axis=0, return_inverse=True)
        self.pair = self.pair.reshape(m, m)
        self.inv_eps = t / eps
        lo, hi = 6.0 + 1e-9, 7.0 + float(np.max(eps)) / t
        if self._eig(lo)[0][m - 1] <= 0:
            raise ValueError(f"reference: no certificate (fewer than {m} levels above 6t)")
        self.e, self.c, self.norm = np.empty(m), np.empty((m, m)), np.empty(m)
        for j in range(m):
            self.e[j] = scipy.optimize.brentq(lambda e: self._eig(e)[0][j], lo, hi,
                                              xtol=1e-15, rtol=4 * np.finfo(float).eps)
            hi = self.e[j]
            self.c[j] = self._eig(self.e[j])[1][:, j]
            # ||G0 P c||^2 = c^T (G0^2)_RR c = -c^T dG0_RR/dE c
            dG = self.green.at(self.e[j], self.disp, deriv=True)[self.pair]
            self.norm[j] = np.sqrt(-self.c[j] @ dG @ self.c[j])

    def _eig(self, e: float):
        """M(e)'s eigenvalues, descending, and their vectors."""
        M = self.green.at(e, self.disp)[self.pair] - np.diag(self.inv_eps)
        w, V = np.linalg.eigh(M)
        return w[::-1], V[:, ::-1]


class _Level:
    """Level j's vector: G0(E_j) at every displacement, the cubes that keep
    all but ``CUT`` of its norm, and its values on any rows."""

    def __init__(self, lv: _Levels, j: int):
        L, m = lv.L, lv.sites.size
        self.lv, self.j = lv, j
        self.table = lv.green.table(lv.e[j])  # [d_z folded, d_x, d_y]
        fz = np.arange(self.table.shape[0])
        mult = np.where((fz == 0) | (2 * fz == L), 1.0, 2.0)
        fx = _fold(np.arange(L), L)
        cheb = np.maximum(np.maximum(fz[:, None, None], fx[None, :, None]), fx[None, None, :])
        shell = np.bincount(cheb.ravel(), minlength=L // 2 + 1,
                            weights=(self.table ** 2 * mult[:, None, None]).ravel())
        tail = np.append(np.cumsum(shell[::-1])[::-1], 0.0)  # tail[W + 1]: beyond W
        c2 = lv.c[j] ** 2
        budget = (CUT / m * lv.norm[j]) ** 2
        # each impurity's least W with c_i^2 tail(W) <= budget; -1: no cube
        self.half = np.array([int(np.argmax(ci * tail <= budget)) - 1 for ci in c2])
        # the impurities whose share of the vector is above TAIL of its norm
        self.terms = np.flatnonzero(np.sqrt(c2 * tail[0]) > TAIL / m * lv.norm[j])

    def rows(self) -> np.ndarray:
        L, parts = self.lv.L, []
        for i in np.flatnonzero(self.half >= 0):
            W = self.half[i]
            o = np.arange(-W, W + 1) if 2 * W + 1 < L else np.arange(L)
            x, y, z = ((self.lv.xyz[i, a] + o) % L for a in range(3))
            parts.append((x[None, None, :] + L * y[None, :, None]
                          + L * L * z[:, None, None]).ravel())
        return np.unique(np.concatenate(parts))

    def on(self, rows: np.ndarray) -> np.ndarray:
        """The unit vector (gauge 1) on ``rows``."""
        L, lv = self.lv.L, self.lv
        x, y, z = _coords(rows, L).T
        v = np.zeros(rows.size)
        for i in self.terms:
            xi, yi, zi = lv.xyz[i]
            v += lv.c[self.j, i] * self.table[_fold(z - zi, L), (x - xi) % L, (y - yi) % L]
        return v / lv.norm[self.j]


KEEP = 10  # levels whose cubes an answer keeps: the cell's wanted pairs
_CACHE: dict = {}


def _solve(a):
    """((t, gauge), levels) of ``a``; the levels of the last model are kept
    for the next call (``keep_rows`` before the window, ``top_pairs``
    after)."""
    a = sp.csr_matrix(a, dtype=np.float64)
    a.sort_indices()
    L, t, s, sites, eps = _model(a)
    key = (L, t, sites.tobytes(), eps.tobytes())
    if key not in _CACHE:
        _CACHE.clear()
        _CACHE[key] = _Levels(L, t, sites, eps)
    return (t, s), _CACHE[key]


def keep_rows(a) -> np.ndarray:
    """The rows of every answer that the judge reads: the cubes of the
    ``KEEP`` largest levels."""
    _, lv = _solve(a)
    k = min(KEEP, lv.sites.size)
    return np.unique(np.concatenate([_Level(lv, j).rows() for j in range(k)]))


def top_pairs(a, k: int) -> Reference:
    """The k largest eigenpairs of the lattice ``a``, certified."""
    a = sp.csr_matrix(a, dtype=np.float64)
    (t, s), lv = _solve(a)
    m, n = lv.sites.size, a.shape[0]
    if m < k or k > KEEP:
        raise ValueError(f"reference: no certificate ({m} levels above the band, {k} wanted, "
                         f"{KEEP} kept)")
    theta = t * lv.e
    resid, kept, levels = np.empty(m), [], []
    for j in range(m):
        level = _Level(lv, j)
        rows = level.rows()
        u = level.on(rows) * s[rows]
        # A u is nought off u's rows and their columns (the pattern is symmetric)
        ext = np.union1d(rows, a[rows].indices)
        full = np.zeros(n)
        full[rows] = u
        resid[j] = np.linalg.norm(a[ext] @ full - theta[j] * full[ext]) / np.linalg.norm(u)
        del full
        if j < KEEP:
            kept.append(rows)
        if j < k:
            levels.append(level)
    tau = 6 * t
    lo_end = theta - resid
    if not (np.all(lo_end > tau) and np.all(lo_end[:-1] > theta[1:] + resid[1:])):
        raise ValueError(f"reference: no certificate (levels {theta.tolist()}, radii "
                         f"{resid.tolist()}, band edge {tau})")
    rows = np.unique(np.concatenate(kept))
    vecs = np.stack([level.on(rows) * s[rows] for level in levels], axis=1)
    return Reference(theta=theta[:k], levels=theta, rows=rows, vecs=vecs, resid=resid,
                     tau=float(max(tau, theta[k] + resid[k]) if m > k else tau))


def judge(ref: Reference, eigs, kept, out_sq) -> dict:
    """``eig_err`` and ``vec_err`` of one answer: its values ``eigs`` (k',),
    its vectors' rows ``ref.rows`` (``kept``, (len(rows), k')) and the
    sums of squares of their other rows ``out_sq`` (k',), all aligned.
    inf where the answer lacks a pair or holds a non-finite number."""
    k = len(ref.theta)
    bad = {"eig_err": np.inf, "vec_err": np.inf}
    if kept is None or out_sq is None:
        return bad
    eigs = np.asarray(eigs, np.float64).ravel()
    kept = np.asarray(kept, np.float64)
    out_sq = np.asarray(out_sq, np.float64).ravel()
    if (eigs.shape[0] < k or kept.ndim != 2 or kept.shape != (ref.rows.size, eigs.shape[0])
            or out_sq.shape != eigs.shape):
        return bad
    order = np.argsort(-eigs, kind="stable")[:k]
    e, K, o = eigs[order], kept[:, order], out_sq[order]
    if not (np.all(np.isfinite(e)) and np.all(np.isfinite(K)) and np.all(np.isfinite(o))):
        return bad
    eig_err = float(np.max(np.abs(e - ref.theta)) / abs(ref.theta[0]))
    sign = np.where(np.sum(K * ref.vecs, axis=0) < 0, -1.0, 1.0)
    vec_sq = np.sum((K - sign * ref.vecs) ** 2, axis=0) + o
    return {"eig_err": eig_err, "vec_err": float(np.sqrt(np.max(vec_sq)))}


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
    the vectors' rows ``keep_rows(a)`` (len(rows), k) as float32, rows).
    The values and vectors are the reference's, each rounded to the
    precision the control computes that output in ("float32" or "tf32")."""
    ref = top_pairs(a, k)
    eigs = _round(eig_precision)(ref.theta).astype(np.float64)
    return eigs, _round(vec_precision)(ref.vecs.astype(np.float32)), ref.rows


# the precision one step below each precision an answer can state
BELOW = {"float64": "float32", "float32": "tf32"}
