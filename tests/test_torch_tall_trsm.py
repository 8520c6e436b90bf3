"""PyTorch port: the tall-skinny triangular solve Y = X R^{-1}
(``ops.cuda_trsm``) on the CPU: its plain version against
torch.linalg.solve_triangular, the layouts the kernel reads, and the
dispatch of ``ops.qr._rsolve`` counted in ``ops.qr.RSOLVE``.  The kernel
itself is held to the plain version on the card in
``tests/test_torch_cuda_kernels.py``.

Tolerances.  Both solves are backward stable: Y R = X + E with |E| <=
gamma_k |Y| |R| (Higham, Accuracy and Stability, Thm 8.5), so the
residual is held to k u ||Y||_F ||R||_F (u the unit roundoff) whatever
R's condition; the two answers differ by at most twice the forward bound,
2 k u cond(R) ||Y||_F, relative."""

import numpy as np
import pytest
import torch

from ca_lanczos_tpu_torch.ops import cuda_trsm, qr

N = 3 * 256 + 37  # not a multiple of any row run of the kernel
KS = (1, 8, 9, 13, 20, 26, 64)
DTYPES = (torch.float32, torch.float64)


def _factor(k, cond, dtype, seed):
    """R = L^T for L the lower Cholesky factor of a Gram matrix with
    eigenvalues from 1 to cond^-2 (so cond(R) = cond), as a CholQR pass
    gets it: a transposed view."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((k, k)))[0]
    sig = np.geomspace(1.0, 1.0 / cond, k)
    L = np.linalg.cholesky((Q * sig**2) @ Q.T)
    return torch.as_tensor(L, dtype=dtype).T


def _block(n, k, dtype, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((n, k)), dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("cond", [10.0, 1e3, 1e6])
def test_plain_matches_the_library(dtype, k, cond):
    R = _factor(k, cond, dtype, seed=k)
    assert not R.is_contiguous() or k == 1  # L.T, as the polish passes it
    X = _block(N, k, dtype, seed=100 + k)
    got = cuda_trsm.tall_trsm_ref(X, R)
    lib = torch.linalg.solve_triangular(R, X, upper=True, left=False)
    u = torch.finfo(dtype).eps / 2
    for Y in (got, lib):
        res = torch.linalg.norm(Y @ torch.triu(R) - X) / (torch.linalg.norm(Y)
                                                          * torch.linalg.norm(R))
        assert float(res) <= k * u
    kappa = float(torch.linalg.cond(R.double()))
    assert float(torch.linalg.norm(got - lib) / torch.linalg.norm(lib)) <= 2 * k * u * kappa
    # a contiguous copy of R gives the same bits
    assert torch.equal(cuda_trsm.tall_trsm_ref(X, R.contiguous()), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_reads_only_the_upper_triangle(dtype):
    k = 13
    R = _factor(k, 10.0, dtype, seed=1).contiguous()
    dirty = R + torch.tril(torch.full((k, k), float("nan"), dtype=dtype), -1)
    X = _block(N, k, dtype, seed=2)
    assert torch.equal(cuda_trsm.tall_trsm_ref(X, dirty), cuda_trsm.tall_trsm_ref(X, R))


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    k = 9
    R = _factor(k, 100.0, dtype, seed=3)
    X = _block(N, k, dtype, seed=4)
    before = dict(cuda_trsm.LAUNCHES)
    assert torch.equal(cuda_trsm.tall_trsm(X, R), cuda_trsm.tall_trsm_ref(X, R))
    assert cuda_trsm.LAUNCHES == before
    with pytest.raises(TypeError):
        cuda_trsm.tall_trsm(X, R.to(torch.float64 if dtype == torch.float32 else torch.float32))
    with pytest.raises(ValueError):
        cuda_trsm.tall_trsm(X, R[:8, :8])


def _views(n, k):
    base = torch.zeros(n, k + 3)
    return {
        "contiguous": (torch.zeros(n, k), (False, k)),
        "column slice": (base[:, 1:k + 1], (False, k + 3)),
        "transposed basis": (torch.zeros(k, n).T, (True, n)),
        "transposed slice": (torch.zeros(k + 2, n + 5)[1:k + 1, :n].T, (True, n + 5)),
        "expanded": (torch.zeros(1, k).expand(n, k), None),
        "every other row": (torch.zeros(2 * n, k)[::2], (False, 2 * k)),
        "every other column": (torch.zeros(n, 2 * k)[:, ::2], None),
    }


@pytest.mark.parametrize("name", list(_views(50, 9)))
def test_layouts_the_kernel_reads(name):
    X, want = _views(50, 9)[name]
    assert cuda_trsm.layout(X) == want
    assert cuda_trsm.fits(X) == (want is not None)


@pytest.mark.parametrize("shape,dtype,fits", [
    ((100, 9), torch.float32, True),
    ((100, 64), torch.float64, True),
    ((100, 1), torch.float32, True),
    ((100, 65), torch.float32, False),
    ((100, 0), torch.float32, False),
    ((100, 9), torch.complex64, False),
    ((100, 9), torch.complex128, False),
    ((100, 9), torch.float16, False),
    ((2, 100, 9), torch.float32, False),
])
def test_dispatch_rule_and_count(shape, dtype, fits):
    """The kernel fits real f32/f64 blocks of 1 to 64 columns; on the CPU
    every block goes to the library, counted."""
    X = torch.ones(shape, dtype=dtype)
    assert cuda_trsm.fits(X) == fits
    if X.dim() != 2 or dtype == torch.float16 or shape[1] == 0:
        return
    k = shape[1]
    R = torch.eye(k, dtype=dtype) * 2
    before = dict(qr.RSOLVE)
    Y = qr._rsolve(X, R)
    assert qr.RSOLVE == {"kernel": before["kernel"], "library": before["library"] + 1}
    assert torch.equal(Y, X / 2)


def test_cholqr_passes_go_through_rsolve():
    """cholqr2 (the polish's CholQR2 too) solves through _rsolve: two
    counted solves a call."""
    X = _block(N, 13, torch.float32, seed=5)
    before = qr.RSOLVE["library"]
    Q = qr.cholqr2(X)[0]
    Q2, R2 = qr.cholqr2(X)
    assert qr.RSOLVE["library"] == before + 4
    eye = torch.eye(13)
    assert float((Q.T @ Q - eye).abs().max()) <= 1e-5
    assert float((Q2.T @ Q2 - eye).abs().max()) <= 1e-5
    assert float((Q2 @ R2 - X).abs().max() / X.abs().max()) <= 1e-5
