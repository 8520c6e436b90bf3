"""Newton change-of-basis matrix (newton_basis_matrix.m:13-60).

Computes the (s+1) x s matrix B with A V_s = V_{s+1} B for the Newton
basis: B[k,k] = lambda_k, B[k+1,k] = 1; the modified form for adjacent
conjugate-pair shifts puts -imag(lambda)^2 on the superdiagonal of the
negative-imaginary member so the recurrence (and the basis) stays real.

Host NumPy, O(s^2): this is driver-setup small math.
"""

from __future__ import annotations

import numpy as np


def newton_basis_matrix(shifts, s: int, modified: bool = False) -> np.ndarray:
    shifts = np.asarray(shifts).ravel()
    if len(shifts) < s:
        raise ValueError(f"need at least s={s} shifts, got {len(shifts)}")
    complex_in = np.iscomplexobj(shifts)
    B = np.zeros((s + 1, s), dtype=np.complex128 if (complex_in and not modified) else np.float64)

    if not modified:
        for k in range(s):
            B[k, k] = shifts[k]
            B[k + 1, k] = 1.0
        if complex_in and np.all(np.imag(np.diagonal(B)) == 0):
            B = B.real
        return B

    for k in range(s):
        lam = complex(shifts[k])
        if lam.imag > 0:
            # Positive-imaginary member must be followed by its conjugate
            # (newton_basis_matrix.m:27-38); at k == s-1 the pair is cut
            # off by the basis length, which the reference treats as an
            # error only if the imaginary part is nonzero there.
            if k + 1 < len(shifts):
                if complex(shifts[k + 1]) != lam.conjugate():
                    raise ValueError(
                        f"modified Leja ordering broken at k={k},{k+1} "
                        "(newton_basis_matrix.m:28-31)"
                    )
            if k == s - 1 and lam.imag != 0:
                raise ValueError(
                    f"complex shift at end of basis without its conjugate "
                    f"(newton_basis_matrix.m:32-38): {lam}"
                )
            B[k, k] = lam.real
        elif lam.imag < 0:
            if k == 0:
                raise ValueError(
                    "negative-imaginary shift first: modified Leja ordering "
                    "violated (newton_basis_matrix.m:41-46)"
                )
            if complex(shifts[k - 1]) != lam.conjugate():
                raise ValueError(
                    f"modified Leja ordering broken at k={k-1},{k} "
                    "(newton_basis_matrix.m:47-51)"
                )
            B[k, k] = lam.real
            B[k - 1, k] = -(lam.imag ** 2)
        else:
            B[k, k] = lam.real
        B[k + 1, k] = 1.0
    return B
