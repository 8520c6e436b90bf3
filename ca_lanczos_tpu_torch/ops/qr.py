"""Tall-skinny QR factorizations (L1 layer).

Counterpart of ``ca_lanczos_tpu/ops/qr.py``: ``tsqr`` (Householder, diag(R)
>= 0, reference tsqr.m:7-12), ``cholqr`` (reference cholqr.m:3-9),
``cholqr2`` (two passes with an escalating diagonal shift on Cholesky
breakdown), and the mixed-precision variants that keep X and Q in the
storage dtype while the Gram product, Cholesky and triangular solve run
in float64.

The Gram products are ``torch.matmul`` (cuBLAS on the card); the
triangular solve of a tall block on the card is the hand-written kernel
of ``ops.cuda_trsm`` (see ``_rsolve``).  The TPU
package ran its float64 reductions row-chunked (``_MP_CHUNK_ROWS``) so no
promoted copy of a tall block was ever resident on a 16 GB chip; on an
80 GB H100 a promoted (11M, 32) block is 2.8 GB, so the port promotes
whole blocks and the chunking is gone.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ca_lanczos_tpu_torch.ops import cuda_trsm

# Every _rsolve call, by where it went: the tall-skinny kernel or the
# library's triangular solve.
RSOLVE = {"kernel": 0, "library": 0}


def _sign_fix(Q: torch.Tensor, R: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip signs so diag(R) >= 0 (tsqr.m:9-11); sign(0) treated as +1."""
    d = torch.sign(torch.diagonal(R).real)
    d = torch.where(d == 0, torch.ones_like(d), d).to(R.dtype)
    return Q * d[None, :], R * d[:, None]


def tsqr(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin QR of X (n, m), n >= m, with diag(R) >= 0."""
    Q, R = torch.linalg.qr(X, mode="reduced")
    return _sign_fix(Q, R)


def _chol_safe(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of a PSD Gram matrix with escalating diagonal shifts
    on breakdown: 0 -> few-ulp (shifted CholQR) -> 1% of trace.  All three
    factorizations are m x m; the first clean one is selected on the
    device (no host synchronisation)."""
    m = G.shape[0]
    real = G.real if G.is_complex() else G
    eps = torch.finfo(real.dtype).eps
    tr = torch.trace(real).to(G.dtype)
    eye = torch.eye(m, dtype=G.dtype, device=G.device)
    L0, i0 = torch.linalg.cholesky_ex(G)
    L1, i1 = torch.linalg.cholesky_ex(G + (11.0 * (m + 1) * eps * tr) * eye)
    L2, _ = torch.linalg.cholesky_ex(G + (0.01 * tr + eps) * eye)
    bad0 = (i0 != 0) | torch.isnan(L0).any()
    bad1 = (i1 != 0) | torch.isnan(L1).any()
    return torch.where(bad0, torch.where(bad1, L2, L1), L0)


def _rsolve(X: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """X R^{-1} for upper-triangular R: the tall-skinny kernel for a real
    float32/float64 block on the card with at most 64 columns, row- or
    column-major (``cuda_trsm.fits``); the library's triangular solve for
    CPU tensors, complex blocks and wider ones.  Counted in ``RSOLVE``."""
    if X.device.type == "cuda" and cuda_trsm.fits(X):
        RSOLVE["kernel"] += 1
        return cuda_trsm.tall_trsm(X, R)
    RSOLVE["library"] += 1
    return torch.linalg.solve_triangular(R, X, upper=True, left=False)


def cholqr(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cholesky QR: G = X^H X, R = chol(G) (upper), Q = X R^{-1}."""
    G = X.conj().T @ X
    R = _chol_safe(G).conj().T
    return _rsolve(X, R), R


def cholqr2(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """CholQR2: two safe Cholesky-QR passes.  Valid to machine
    orthogonality for cond(X) < ~eps^{-1/2}; beyond that the escalating
    shifts keep the result finite."""
    Q1, R1 = cholqr(X)
    Q2, R2 = cholqr(Q1)
    return Q2, R2 @ R1


def _f64(X: torch.Tensor) -> torch.Tensor:
    return X.to(torch.complex128 if X.is_complex() else torch.float64)


def tsqr_mp(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tsqr with the factorization in float64; Q returns in X's dtype,
    R stays float64 (OrthParams.mixed_precision)."""
    Q, R = tsqr(_f64(X))
    return Q.to(X.dtype), R


def gram_f64(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X^H Y accumulated in float64."""
    return _f64(X).conj().T @ _f64(Y)


def sub_proj_f64(X: torch.Tensor, Q: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(X - Q R) computed in float64, returned in X's storage dtype."""
    return (_f64(X) - _f64(Q) @ R).to(X.dtype)


def rsolve_f64(X: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """X R^{-1} with the triangular solve in float64, returned in X's
    storage dtype."""
    return _rsolve(_f64(X), R).to(X.dtype)


def cholqr_mp(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cholqr with the Gram product, Cholesky and triangular solve in
    float64 while X (and the returned Q) stay in the storage dtype.  The
    f64 Gram is the accuracy lever: G = X^H X in f32 loses ~2^-24
    relative, the eigenvalue error floor of a pure-f32 solve."""
    G = gram_f64(X, X)
    R = _chol_safe(G).conj().T
    return rsolve_f64(X, R), R


def cholqr2_mp(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two mixed-precision CholQR passes (see cholqr2)."""
    Q1, R1 = cholqr_mp(X)
    Q2, R2 = cholqr_mp(Q1)
    return Q2, R2 @ R1
