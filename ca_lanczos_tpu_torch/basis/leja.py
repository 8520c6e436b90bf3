"""Leja point orderings for the Newton Krylov basis (L2 layer).

Pure host NumPy: the greedy selection is sequential O(s^2) scalar work —
never worth tracing (SURVEY.md section 7 layer 3).

Variants mirroring the reference:

* ``nonmodified_leja`` — greedy max-product ordering seeded with the
  max-modulus point, with a running "capacity" estimate rescaling points
  to avoid over/underflow (nonmodified_leja.m:24-108).
* ``modified_leja`` — same greedy scheme but complex-conjugate pairs are
  kept adjacent (positive-imaginary first) and selected atomically
  (modified_leja.m:24-181).
* ``real_leja`` — uniquify with multiplicities, sort by real part,
  normalize conjugate-pair order, then modified_leja (real_leja.m:18-87).
* ``complex_leja`` — simple ordering without multiplicity handling
  (complex_leja.m:11-59; never called by the reference drivers).

Documented deliberate divergences from the reference:

1. The capacity update in nonmodified_leja.m:57-62 overwrites ``capacity``
   inside its loop, so only the last chosen point contributes; we use the
   intended full product (matching modified_leja.m:100-102).
2. The product terms at nonmodified_leja.m:83 divide only the *chosen*
   point by the capacity due to parenthesization; we scale the whole
   difference (matching modified_leja.m:127).

Both divergences only affect floating-point scaling, not which points are
selected in well-conditioned cases.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ca_lanczos_tpu_torch.config import LejaVariant


def count_multiplicities(x: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Unique values of x plus their occurrence counts
    (count_multiplicities.m:5-41).

    Complex values sort like MATLAB ``unique`` is not guaranteed; only the
    (value -> count) mapping is contractual.
    """
    x = np.asarray(x)
    y, counts = np.unique(x, return_counts=True)
    return y, counts


def _is_conj_pair(a: complex, b: complex) -> bool:
    """Strict conjugate-pair test; rejects real pairs (modified_leja.m:26-39)."""
    return bool(a.real == b.real and a.imag == -b.imag and a.imag != 0)


def _update_capacity(xs: np.ndarray, ys: list, out: list, mults: np.ndarray, capacity: float):
    """Rescale points by the running capacity estimate
    (modified_leja.m:95-117): capacity = prod |y_last - chosen_i|^(m_i/num).
    """
    num = len(out)
    if num <= 1:
        return xs, ys, capacity
    old = capacity
    y_last = xs[out[-1]]
    prev = np.asarray(out[:-1])
    capacity = float(np.prod(np.abs(y_last - xs[prev]) ** (mults[prev] * (1.0 / num))))
    scale = capacity / old
    xs = xs / scale
    ys = [y / scale for y in ys]
    return xs, ys, capacity


def _zprod(xs: np.ndarray, j: int, out: list, mults: np.ndarray, capacity: float) -> float:
    prev = np.asarray(out)
    return float(np.prod((np.abs(xs[j] - xs[prev]) / capacity) ** mults[prev]))


def _check_max(val: float) -> None:
    if val == 0:
        raise ValueError(
            "Leja product to maximize is zero: repeated shifts or underflow "
            "(nonmodified_leja.m:94-97)"
        )
    if np.isinf(val):
        raise ValueError("Leja product to maximize overflowed (nonmodified_leja.m:97-99)")


def nonmodified_leja(x, mults=None) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy Leja ordering; returns (y, idx) with x[idx] == y."""
    x = np.asarray(x)
    n = len(x)
    if mults is None:
        mults = np.ones(n)
    mults = np.asarray(mults, dtype=float)
    if n == 0:
        return x.copy(), np.array([], dtype=int)

    xs = x.astype(np.complex128) if np.iscomplexobj(x) else x.astype(np.float64)
    out = [int(np.argmax(np.abs(xs)))]
    ys = [xs[out[0]]]
    capacity = 1.0
    remaining = [j for j in range(n) if j != out[0]]

    while remaining:
        xs, ys, capacity = _update_capacity(xs, ys, out, mults, capacity)
        zp = [_zprod(xs, j, out, mults, capacity) for j in remaining]
        k = int(np.argmax(zp))
        _check_max(zp[k])
        j = remaining.pop(k)
        out.append(j)
        ys.append(xs[j])

    y = np.asarray(ys) * capacity
    if not np.iscomplexobj(x):
        y = y.real
    return y, np.asarray(out)


def modified_leja(x, mults=None) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy Leja ordering keeping conjugate pairs adjacent and atomic.

    Input convention (modified_leja.m:6-14): complex entries occur in
    adjacent conjugate pairs with the positive-imaginary member first.
    """
    x = np.asarray(x)
    n = len(x)
    if mults is None:
        mults = np.ones(n)
    mults = np.asarray(mults, dtype=float)
    if n == 0:
        return x.copy(), np.array([], dtype=int)

    xs = x.astype(np.complex128)

    def take(j: int, out: list, remaining: set) -> None:
        """Select point j, atomically including its conjugate partner."""
        if xs[j].imag == 0:
            out.append(j)
            remaining.discard(j)
        elif j > 0 and _is_conj_pair(xs[j - 1], xs[j]):
            if xs[j - 1].imag < 0:
                raise ValueError(
                    f"conjugate pair out of order at {j-1},{j} (modified_leja.m:150-153)"
                )
            out.extend([j - 1, j])
            remaining.discard(j - 1)
            remaining.discard(j)
        elif j < n - 1 and _is_conj_pair(xs[j], xs[j + 1]):
            if xs[j].imag < 0:
                raise ValueError(
                    f"conjugate pair out of order at {j},{j+1} (modified_leja.m:160-162)"
                )
            out.extend([j, j + 1])
            remaining.discard(j)
            remaining.discard(j + 1)
        else:
            raise ValueError(
                "complex shift without adjacent conjugate partner "
                "(modified_leja.m:170-175)"
            )

    out: list = []
    remaining = set(range(n))
    take(int(np.argmax(np.abs(xs))), out, remaining)
    ys = [xs[j] for j in out]
    capacity = 1.0

    while remaining:
        xs, ys, capacity = _update_capacity(xs, ys, out, mults, capacity)
        cands = sorted(remaining)
        zp = [_zprod(xs, j, out, mults, capacity) for j in cands]
        k = int(np.argmax(zp))
        _check_max(zp[k])
        before = len(out)
        take(cands[k], out, remaining)
        ys.extend(xs[j] for j in out[before:])

    y = np.asarray(ys) * capacity
    if not np.iscomplexobj(x) and np.all(y.imag == 0):
        y = y.real
    return y, np.asarray(out)


def real_leja(x) -> Tuple[np.ndarray, np.ndarray]:
    """Uniquify + multiplicity count, sort by real part, fix conjugate-pair
    order, then modified Leja (real_leja.m:18-87).

    NOTE (real_leja.m:83-85): when x has repeated entries the returned idx
    indexes the *uniquified* points, not the input.
    """
    x = np.asarray(x).ravel()
    y, mults = count_multiplicities(x)
    order = np.argsort(y.real, kind="stable")
    y = y[order].astype(np.complex128)
    mults = mults[order]

    k = 0
    m = len(y)
    while k < m - 1:
        if y[k].imag != 0:
            if y[k].real == y[k + 1].real and y[k].imag == -y[k + 1].imag:
                im = abs(y[k].imag)
                y[k] = y[k].real + 1j * im
                y[k + 1] = y[k].real - 1j * im
                k += 2
            else:
                raise ValueError("unpaired complex shift in real_leja (real_leja.m:76)")
        else:
            k += 1

    if not np.iscomplexobj(x) or np.all(y.imag == 0):
        y = y.real
    return modified_leja(y, mults)


def complex_leja(x) -> Tuple[np.ndarray, np.ndarray]:
    """Simple Leja ordering without multiplicity handling
    (complex_leja.m:11-59)."""
    x = np.asarray(x).ravel()
    n = len(x)
    y = x.astype(np.complex128).copy()
    idx = np.arange(n)
    j = int(np.argmax(np.abs(y)))
    y[[0, j]] = y[[j, 0]]
    idx[[0, j]] = idx[[j, 0]]
    for k in range(1, n):
        prods = np.array([np.prod(np.abs(y[c] - y[:k])) for c in range(k, n)])
        mx = int(np.argmax(prods))
        if prods[mx] == 0:
            raise ValueError("multiple shifts require special handling (complex_leja.m:33-36)")
        j = k + mx
        y[[k, j]] = y[[j, k]]
        idx[[k, j]] = idx[[j, k]]
    if not np.iscomplexobj(x):
        y = y.real
    return y, idx


def leja(x, variant: LejaVariant = LejaVariant.NONMODIFIED) -> np.ndarray:
    """Explicit-variant Leja dispatcher.

    The reference's dispatcher (leja.m:23-31) routes *any* two-argument
    call to real_leja — so ``leja(eigs,'nonmodified')`` in the eigensolver
    drivers (ca_lanczos.m:70) actually ran the real/modified path, while
    the propagators' single-argument call (ca_lanczos_prop.m:40) ran the
    true nonmodified path.  Our drivers pass the variant that the
    reference actually executed.
    """
    variant = LejaVariant(variant)
    if variant == LejaVariant.NONMODIFIED:
        y, _ = nonmodified_leja(x)
    elif variant == LejaVariant.MODIFIED:
        y, _ = modified_leja(x)
    elif variant == LejaVariant.REAL:
        y, _ = real_leja(x)
    elif variant == LejaVariant.COMPLEX:
        y, _ = complex_leja(x)
    else:  # pragma: no cover
        raise ValueError(f"unknown Leja variant {variant}")
    return y
