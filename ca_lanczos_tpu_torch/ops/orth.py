"""Block orthogonalization: project / normalize / project_and_normalize.

Counterpart of ``ca_lanczos_tpu/ops/orth.py``, the L1 "BLAS-3 QR layer" of
the reference (project.m, normalize.m, projectAndNormalize.m):

* The heavy ops — block Gram products ``Q^H X`` and the tall-skinny QR
  (``ops.qr``) — are tensor ops on the basis' device (cuBLAS / cuSOLVER
  on the card).
* The small R factors come back to the host as numpy arrays (one
  ``.cpu()`` per factor), where all O(s^2) control logic (rank decisions,
  second-pass triggers, the Tk recurrence in the drivers) runs.

Blocks are (n, k) tensors of any strides: the drivers keep each basis as
(k, n) rows, so that every vector is contiguous for the SpMV kernels, and
hand its transposed views in here.

Semantics mirrored from the reference:

* ``project`` — block classical Gram-Schmidt, sequential over Q blocks
  (project.m:32-39), with an optional second pass.  NOTE the reference's
  second-pass trigger at project.m:44-46 fires when *no* column lost more
  than half its norm (``max(rho*normBefore - normAfter) < 0``) — the
  conventional BCGS2 criterion inverted.  We reproduce it by default
  (OrthParams.reference_second_pass) and offer the conventional test.
* ``normalize`` — TSQR + SVD rank check (sigma_i <= tol * sigma_1,
  tol=1e-8) with optional null-space randomization (normalize.m:3-51).
  The random columns come from a ``torch.Generator`` (the JAX package
  takes a PRNG key); without one, a fresh generator is seeded from the
  operating system's entropy, as the JAX package does.
* ``project_and_normalize`` — project then rank-revealing normalize, with
  a full second pass if any column norm of the normalization R dropped by
  more than 50% relative to the input column norm
  (projectAndNormalize.m:10,43-84); R blocks accumulate across passes
  while the normalization R is replaced (projectAndNormalize.m:65,71-73).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ca_lanczos_tpu_torch.config import OrthParams, QrMethod
from ca_lanczos_tpu_torch.ops.qr import (
    cholqr2,
    cholqr2_mp,
    gram_f64,
    sub_proj_f64,
    tsqr,
    tsqr_mp,
)

DEFAULT_ORTH_PARAMS = OrthParams()


def _qr(X: torch.Tensor, params: OrthParams):
    mp = params.mixed_precision and X.dtype != torch.float64
    if QrMethod(params.qr_method) == QrMethod.CHOLQR2:
        return cholqr2_mp(X) if mp else cholqr2(X)
    return tsqr_mp(X) if mp else tsqr(X)


def _proj_block(Q: torch.Tensor, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One CGS block step: R = Q^H X; X <- X - Q R."""
    R = Q.conj().T @ X
    return X - Q @ R, R


def _proj_block_mp(Q: torch.Tensor, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """CGS block step with the Gram product and correction in float64
    (OrthParams.mixed_precision); the updated block returns in X's dtype."""
    R = gram_f64(Q, X)
    return sub_proj_f64(X, Q, R), R


def _col_norms(X: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.abs(X) ** 2, dim=0))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _as_2d(X: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    if X.ndim == 1:
        return X[:, None], True
    return X, False


def _is_empty(Q) -> bool:
    return Q is None or Q.numel() == 0


def project(
    Q_blocks: Sequence[Optional[torch.Tensor]],
    X: torch.Tensor,
    reorth: bool = False,
    params: OrthParams = DEFAULT_ORTH_PARAMS,
) -> Tuple[torch.Tensor, List[np.ndarray]]:
    """Project X against a list of orthonormal blocks (project.m:7-58).

    Returns (Y, R_blocks) with Y on X's device and R blocks as host numpy
    arrays; when ``reorth`` and the trigger fires, R blocks include the
    second pass' coefficients (R{i} += R2{i}, project.m:47-55).
    """
    X2, was_vec = _as_2d(X)
    m = X2.shape[1]

    if all(_is_empty(Q) for Q in Q_blocks):
        Y = X2[:, 0] if was_vec else X2
        return Y, [np.zeros((0, m)) for _ in Q_blocks]

    norm_before = _col_norms(X2) if reorth else None

    # Sequential block CGS; empty blocks keep a (0, m) placeholder so that
    # R_blocks stays positionally aligned with Q_blocks (project.m:32-39).
    R_blocks: List[np.ndarray] = []
    Y = X2
    proj = (
        _proj_block_mp
        if params.mixed_precision and X2.dtype != torch.float64
        else _proj_block
    )
    for Q in Q_blocks:
        if _is_empty(Q):
            R_blocks.append(np.zeros((0, m)))
            continue
        Y, R = proj(_as_2d(Q)[0], Y)
        R_blocks.append(_host(R))

    if reorth:
        norm_after = _col_norms(Y)
        diff = _host(params.reorth_tol * norm_before - norm_after)
        if params.reference_second_pass:
            # Reference quirk (project.m:44-46): second pass when NO column
            # dropped below rho * its original norm.
            do_second = bool(np.max(diff) < 0)
        else:
            # Conventional BCGS2: second pass when ANY column dropped.
            do_second = bool(np.max(diff) > 0)
        if do_second:
            for i, Q in enumerate(Q_blocks):
                if _is_empty(Q):
                    continue
                Y, R2 = proj(_as_2d(Q)[0], Y)
                R_blocks[i] = R_blocks[i] + _host(R2)

    if was_vec:
        Y = Y[:, 0]
    return Y, R_blocks


def normalize(
    X: torch.Tensor,
    randomize: bool = False,
    params: OrthParams = DEFAULT_ORTH_PARAMS,
    generator: Optional[torch.Generator] = None,
    Q_against: Sequence[Optional[torch.Tensor]] = (),
) -> Tuple[torch.Tensor, np.ndarray, int]:
    """Rank-revealing orthonormalization (normalize.m:3-51).

    TSQR, then SVD of the small R; numerical rank is the count of singular
    values > rank_tol * sigma_1.  With ``randomize`` and a rank-deficient
    block, the null-space columns are replaced by uniform random vectors
    drawn from ``generator``, projected against the full-rank columns (and
    any ``Q_against`` blocks), and re-orthonormalized (normalize.m:38-51).

    Returns (Q tensor, R numpy, rank).
    """
    X2, was_vec = _as_2d(X)
    m = X2.shape[1]
    Q, R = _qr(X2, params)
    R_np = _host(R)
    U, S, Wh = np.linalg.svd(R_np)
    abs_tol = params.rank_tol * (S[0] if S.size else 0.0)
    rank = int(np.sum(S > abs_tol))

    if rank == m or not randomize:
        if was_vec:
            Q = Q[:, 0]
        return Q, R_np, rank

    # Randomize the null space (normalize.m:28-31,38-51).
    R_np = np.diag(S) @ Wh  # R = S * W'
    Q = Q @ torch.as_tensor(U, dtype=Q.dtype, device=Q.device)
    n = Q.shape[0]
    n_null = m - rank
    if generator is None:
        generator = torch.Generator(device=Q.device)
        generator.seed()
    real = Q.real.dtype if Q.is_complex() else Q.dtype
    rnd = torch.rand((n, n_null), generator=generator, dtype=real,
                     device=Q.device).to(Q.dtype)
    blocks = [Q[:, :rank]] + [b for b in Q_against if not _is_empty(b)]
    rnd, _ = project(blocks, rnd)
    rnd_q, _ = _qr(rnd, params)
    Q[:, rank:] = rnd_q
    if was_vec:
        Q = Q[:, 0]
    return Q, R_np, rank


@dataclasses.dataclass
class PNResult:
    """Result of project_and_normalize.

    Q: orthonormalized block (tensor).
    R_blocks: projection coefficients, one per input Q block (host numpy).
    R: the normalization R factor from the *last* normalize pass (host
       numpy) — the reference returns this at RZ{numBlocksQ+1}
       (projectAndNormalize.m:27,65).
    rank: numerical rank from the last normalize.
    second_pass: whether the 50%-drop trigger fired.
    """

    Q: torch.Tensor
    R_blocks: List[np.ndarray]
    R: np.ndarray
    rank: int
    second_pass: bool


def project_and_normalize(
    Q_blocks: Sequence[Optional[torch.Tensor]],
    X: torch.Tensor,
    reorth: bool = True,
    params: OrthParams = DEFAULT_ORTH_PARAMS,
    randomize: bool = False,
    generator: Optional[torch.Generator] = None,
) -> PNResult:
    """Block CGS + rank-revealing QR with conditional second pass.

    (projectAndNormalize.m:3-90.)
    """
    X2, was_vec = _as_2d(X)

    norms_before = _host(_col_norms(X2)) if reorth else None

    Y, RY = project(Q_blocks, X2, reorth=False, params=params)
    QY, R1, rank = normalize(Y, randomize=randomize, params=params, generator=generator,
                             Q_against=Q_blocks)

    second = False
    if reorth and norms_before is not None:
        # Column norms after the first pass, read off the normalization R
        # (projectAndNormalize.m:44-48).
        norms_after = np.sqrt(np.sum(np.abs(R1) ** 2, axis=0))
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.abs(norms_before - norms_after) / norms_before
        second = bool(np.max(rel) > params.reorth_tol)

    if not second:
        Q_out, R_blocks, R_out, rank_out = QY, RY, R1, rank
    else:
        Z, RZ = project(Q_blocks, Y, reorth=False, params=params)
        QZ, R2, rank2 = normalize(Z, randomize=randomize, params=params, generator=generator,
                                  Q_against=Q_blocks)
        # Accumulate projection coefficients across passes
        # (projectAndNormalize.m:71-73); normalization R is replaced.
        R_blocks = [a + b for a, b in zip(RY, RZ)] if RY else RZ
        Q_out, R_out, rank_out = QZ, R2, rank2

    if was_vec:
        Q_out = Q_out[:, 0]
    return PNResult(Q=Q_out, R_blocks=R_blocks, R=R_out, rank=rank_out, second_pass=second)
