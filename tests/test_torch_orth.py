"""PyTorch port, ops/orth.py (project / normalize / project_and_normalize)
against the JAX package on identical numpy inputs (mirrors
tests/test_orth.py).

Tolerances: R blocks and normalization R 1e-12 relative to their largest
entry, Y and Q 1e-11 absolute (f64); rank and ``second_pass`` equal.  The
f32 mixed-precision case keeps f64 R factors from f32 inputs: 1e-12
relative there too, and the f32 Y at 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ca_lanczos_tpu.config import OrthParams as JParams
from ca_lanczos_tpu.ops import orth as jorth
from ca_lanczos_tpu_torch.config import OrthParams, QrMethod
from ca_lanczos_tpu_torch.ops import orth
from ca_lanczos_tpu_torch.ops.qr import tsqr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers per
    core set, and torch's OpenMP pools oversubscribe the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tall(n=200, m=6, seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, m))
    if complex_:
        X = X + 1j * rng.standard_normal((n, m))
    return X


def _basis(seed, m=6, complex_=False):
    Q, _ = np.linalg.qr(_tall(m=m, seed=seed, complex_=complex_))
    return Q


def _close_R(got, want, rtol=1e-12):
    want = np.asarray(want)
    assert got.shape == want.shape
    if not want.size:
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _params(**kw):
    return OrthParams(**kw), JParams(**kw)


@pytest.mark.parametrize("reference", [True, False])
@pytest.mark.parametrize("complex_", [False, True])
def test_project_matches_jax(reference, complex_):
    Q1 = _basis(1, complex_=complex_)
    Q2 = np.linalg.qr(_tall(m=4, seed=2, complex_=complex_)
                      - Q1 @ (Q1.conj().T @ _tall(m=4, seed=2, complex_=complex_)))[0]
    X = _tall(seed=3, complex_=complex_)
    pt, pj = _params(reference_second_pass=reference)
    Yj, Rj = jorth.project([jnp.asarray(Q1), None, jnp.asarray(Q2)], jnp.asarray(X),
                           reorth=True, params=pj)
    blocks = [torch.as_tensor(Q1), None, torch.as_tensor(Q2)]
    Y, R = orth.project(blocks, torch.as_tensor(X), reorth=True, params=pt)
    assert len(R) == 3 and R[1].shape == (0, 6)
    for got, want in zip(R, Rj):
        _close_R(got, want)
    np.testing.assert_allclose(Y.numpy(), np.asarray(Yj), rtol=0, atol=1e-11)
    # Y orthogonal to both blocks, and X = Q1 R1 + Q2 R2 + Y
    assert np.abs(Q1.conj().T @ Y.numpy()).max() < 1e-12
    np.testing.assert_allclose(Q1 @ R[0] + Q2 @ R[2] + Y.numpy(), X, atol=1e-12)


def test_project_second_pass_triggers_like_jax():
    # generic X (no column collapses): only the reference trigger fires,
    # and its R blocks carry both passes
    Q = _basis(14)
    X = _tall(seed=15)
    for reference in (True, False):
        pt, pj = _params(reference_second_pass=reference)
        _, Rj = jorth.project([jnp.asarray(Q)], jnp.asarray(X), reorth=True, params=pj)
        _, R = orth.project([torch.as_tensor(Q)], torch.as_tensor(X), reorth=True, params=pt)
        _, R1 = orth.project([torch.as_tensor(Q)], torch.as_tensor(X), reorth=False, params=pt)
        _close_R(R[0], Rj[0])
        # the second pass adds a roundoff-level correction to the first's R
        assert (np.abs(R[0] - R1[0]).max() > 0) == reference


def test_project_vector_and_empty_blocks():
    Q = _basis(12)
    x = np.random.default_rng(13).standard_normal(200)
    y, R = orth.project([torch.as_tensor(Q)], torch.as_tensor(x))
    yj, Rj = jorth.project([jnp.asarray(Q)], jnp.asarray(x))
    assert y.ndim == 1 and R[0].shape == (6, 1)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-12)
    X = torch.as_tensor(_tall(seed=11))
    Y, R = orth.project([None, torch.zeros((200, 0), dtype=torch.float64)], X)
    assert torch.equal(Y, X) and len(R) == 2 and R[0].shape == (0, 6)


def test_project_mixed_precision_f32():
    Q = _basis(4).astype(np.float32)
    X = _tall(seed=5).astype(np.float32)
    pt, pj = _params(mixed_precision=True)
    Yj, Rj = jorth.project([jnp.asarray(Q)], jnp.asarray(X), reorth=True, params=pj)
    Y, R = orth.project([torch.as_tensor(Q)], torch.as_tensor(X), reorth=True, params=pt)
    assert Y.dtype == torch.float32 and R[0].dtype == np.float64
    _close_R(R[0], Rj[0])
    np.testing.assert_allclose(Y.numpy(), np.asarray(Yj), rtol=0, atol=1e-6)


def test_project_on_transposed_row_storage():
    # the drivers hand (n, k) views of (k, n) row storage
    Q = _basis(6)
    X = _tall(seed=7)
    rows = torch.as_tensor(np.ascontiguousarray(Q.T))
    Y, R = orth.project([rows.T], torch.as_tensor(X), reorth=True)
    Yj, Rj = jorth.project([jnp.asarray(Q)], jnp.asarray(X), reorth=True)
    _close_R(R[0], Rj[0])
    np.testing.assert_allclose(Y.numpy(), np.asarray(Yj), atol=1e-11)


@pytest.mark.parametrize("qr_method", ["tsqr", "cholqr2"])
def test_normalize_full_rank_matches_jax(qr_method):
    X = _tall(seed=3)
    pt, pj = _params(qr_method=QrMethod(qr_method))
    Qj, Rj, rj = jorth.normalize(jnp.asarray(X), params=pj)
    Q, R, rank = orth.normalize(torch.as_tensor(X), params=pt)
    assert rank == rj == 6
    _close_R(R, Rj)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=0, atol=1e-11)
    np.testing.assert_allclose(Q.numpy() @ R, X, atol=1e-12)


def test_normalize_rank_deficient_matches_jax():
    base = np.random.default_rng(4).standard_normal((100, 3))
    X = np.column_stack([base, base[:, 0] + base[:, 1], base[:, 2] * 2])
    _, Rj, rj = jorth.normalize(jnp.asarray(X))
    _, R, rank = orth.normalize(torch.as_tensor(X))
    assert rank == rj == 3
    _close_R(R, Rj)


def test_normalize_randomized_null_space():
    # the random columns differ by design (torch.Generator vs a JAX key):
    # the full-rank part, R and the rank agree; all columns orthonormal
    base = np.random.default_rng(5).standard_normal((100, 3))
    X = np.column_stack([base, base[:, 0], base[:, 1]])
    Qj, Rj, rj = jorth.normalize(jnp.asarray(X), randomize=True, key=jnp.zeros(2, jnp.uint32))
    gen = torch.Generator().manual_seed(0)
    Q, R, rank = orth.normalize(torch.as_tensor(X), randomize=True, generator=gen)
    assert rank == rj == 3
    _close_R(R, Rj)
    np.testing.assert_allclose(np.abs(Q.numpy()[:, :3]), np.abs(np.asarray(Qj)[:, :3]),
                               atol=1e-11)
    np.testing.assert_allclose(Q.numpy().T @ Q.numpy(), np.eye(5), atol=1e-10)
    # the same generator state gives the same columns
    Q2, _, _ = orth.normalize(torch.as_tensor(X), randomize=True,
                              generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(Q2, Q, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["generic", "near_dependent", "no_blocks"])
def test_project_and_normalize_matches_jax(case):
    Q1 = _basis(16)
    if case == "near_dependent":
        # columns nearly inside span(Q1): the 50%-drop second pass fires
        noise = np.random.default_rng(19).standard_normal((200, 3))
        X = Q1[:, :3] + 1e-6 * noise
    else:
        X = _tall(seed=17)
    blocks = [] if case == "no_blocks" else [Q1]
    rj = jorth.project_and_normalize([jnp.asarray(b) for b in blocks], jnp.asarray(X))
    rt = orth.project_and_normalize([torch.as_tensor(b) for b in blocks], torch.as_tensor(X))
    assert rt.second_pass == rj.second_pass == (case == "near_dependent")
    assert rt.rank == rj.rank
    assert len(rt.R_blocks) == len(rj.R_blocks)
    for got, want in zip(rt.R_blocks, rj.R_blocks):
        _close_R(got, want)
    _close_R(rt.R, rj.R)
    Qn = rt.Q.numpy()
    np.testing.assert_allclose(Qn, np.asarray(rj.Q), rtol=0, atol=1e-8)
    np.testing.assert_allclose(Qn.T @ Qn, np.eye(Qn.shape[1]), atol=1e-8)
    if blocks:
        assert np.abs(Q1.T @ Qn).max() < 1e-7


def test_project_and_normalize_complex():
    Q1 = _basis(21, complex_=True)
    X = _tall(seed=22, complex_=True)
    rj = jorth.project_and_normalize([jnp.asarray(Q1)], jnp.asarray(X))
    rt = orth.project_and_normalize([torch.as_tensor(Q1)], torch.as_tensor(X))
    assert rt.second_pass == rj.second_pass and rt.rank == rj.rank == 6
    _close_R(rt.R_blocks[0], rj.R_blocks[0])
    _close_R(rt.R, rj.R)
    Qn = rt.Q.numpy()
    np.testing.assert_allclose(Q1 @ rt.R_blocks[0] + Qn @ rt.R, X, atol=1e-11)
    np.testing.assert_allclose(Qn.conj().T @ Qn, np.eye(6), atol=1e-12)


def test_tsqr_on_column_major_view():
    # the row-stored basis hands TSQR a column-major (n, k) view
    X = _tall(seed=30)
    Q1, R1 = tsqr(torch.as_tensor(X))
    Q2, R2 = tsqr(torch.as_tensor(np.ascontiguousarray(X.T)).T)
    torch.testing.assert_close(R2, R1, rtol=0, atol=1e-13)
    torch.testing.assert_close(Q2, Q1, rtol=0, atol=1e-13)
