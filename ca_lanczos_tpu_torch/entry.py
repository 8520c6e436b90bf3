"""Driver entry points of the port: the single-card block step and the
multi-rank dry run.

Counterpart of the repo's ``__graft_entry__.py`` (which stays the JAX
package's):

* :func:`entry` — (fn, example_args): one CA-Lanczos block step on a
  banded operator (matrix powers, two-pass block CGS, TSQR), the
  per-iteration device work of ``restarted_ca_lanczos``.
* :func:`dryrun_multichip` — ``n`` ranks (``parallel.runtime.spawn``: one
  card each, or gloo CPU ranks with ``device="cpu"``) run the distributed
  block step and ``dist_ca_lanczos`` on the natural and interleaved
  engines, the general-sparsity engine (a DistPell: K4 on each rank's
  window), the locked restarted driver and the distributed IRL, each
  holding its Ritz values to the single-card port or to a planted
  spectrum.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): the single-card CA block step on ``device``."""
    from ca_lanczos_tpu_torch.ops.matrix_powers import matrix_powers_monomial
    from ca_lanczos_tpu_torch.ops.qr import tsqr
    from ca_lanczos_tpu_torch.utils.matrices import laplacian_1d

    s = 6
    n = 256

    def ca_block_step(A, Q_prev):
        """Matrix powers from the previous block's last column, two-pass
        block CGS against the previous block, TSQR."""
        q = Q_prev[:, -1].contiguous()
        V = matrix_powers_monomial(A, q, s)
        X = V[:, 1:]
        R = torch.zeros((Q_prev.shape[1], s), dtype=X.dtype, device=X.device)
        for _ in range(2):
            Rp = Q_prev.T @ X
            X = X - Q_prev @ Rp
            R = R + Rp
        Q_new, Rn = tsqr(X)
        return Q_new, R, Rn

    A = laplacian_1d(n, dtype=torch.float32, device=device)
    Q_prev, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((n, s + 1)))
    return ca_block_step, (A, torch.as_tensor(Q_prev, dtype=torch.float32, device=device))


def _planted_diag(n: int, top: np.ndarray):
    from ca_lanczos_tpu_torch.ops.spmv import DiaMatrix

    d = np.linspace(1.0, 10.0, n).astype(np.float32)
    d[-len(top):] = top
    return DiaMatrix(data=torch.as_tensor(d[None, :]), offsets=(0,))


def _ritz_parity(res, A, r, s: int, steps: int, tag: str, rtol: float = 5e-4) -> None:
    from ca_lanczos_tpu_torch.solvers.ca_lanczos import ca_lanczos

    host = ca_lanczos(A.to(res.op.device), torch.as_tensor(r, device=res.op.device), s, steps)
    want = np.linalg.eigvalsh(np.asarray(host.T, np.float64))
    got = np.linalg.eigvalsh(np.asarray(res.T, np.float64))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol,
                               err_msg=f"{tag}: dist Ritz spectrum diverges from the single card")


def _dryrun_rank() -> dict:
    """One rank of :func:`dryrun_multichip`; returns what it checked."""
    import scipy.sparse as sp
    import torch.distributed as dist

    from ca_lanczos_tpu_torch.config import LanczosConfig
    from ca_lanczos_tpu_torch.ops.spmv import EllMatrix
    from ca_lanczos_tpu_torch.parallel import (
        DistDia,
        DistPell,
        dist_ca_block,
        dist_ca_lanczos,
        dist_first_block,
        dist_impl_restarted_ca_lanczos,
        dist_restarted_ca_lanczos,
        make_hier_mesh,
        make_mesh,
    )
    from ca_lanczos_tpu_torch.parallel.restarted import (
        _dist_ca_block_locked,
        _dist_first_block_locked,
        _dist_ritz_vector,
    )
    from ca_lanczos_tpu_torch.solvers._block import block_T, extend_T, first_block_T
    from ca_lanczos_tpu_torch.solvers.ca_lanczos import monomial_basis_matrix
    from ca_lanczos_tpu_torch.utils.matrices import laplacian_1d

    P = dist.get_world_size()
    s = 4
    mesh = make_mesh(P)
    n = P * 8 * (s + 1)
    A = laplacian_1d(n, dtype=torch.float32, device="cpu")
    Adist = DistDia.from_dia(A, mesh, s_max=s)
    Bk = monomial_basis_matrix(s)
    z = np.zeros(s)
    q = Adist.shard_entry(np.ones(n) / np.sqrt(n))

    Qb, Rk = dist_first_block(Adist, q, z, z, s, mesh)
    T, b0 = first_block_T(Rk, Bk, s)
    Q_new, Rkk, R = dist_ca_block(Adist, Qb, z, z, s, mesh)
    Tk, b1, _ = block_T(Rkk, R, Bk, b0, s)
    T = extend_T(T, Tk, b0, b1, s)
    assert T.shape == (2 * s + 1, 2 * s) and np.isfinite(T).all(), T.shape

    Qconv = Adist.state_zeros(4)
    Qb2, _, _ = _dist_first_block_locked(Adist, q, Qconv, z, z, s, mesh)
    _dist_ca_block_locked(Adist, Qb2, Qconv, z, z, s, mesh)
    x = _dist_ritz_vector(Qb2, np.ones(s + 1))
    assert tuple(x.shape) == (Adist.n_local,)

    rng = np.random.default_rng(1)
    n_ilv = P * 1024
    A_ilv = laplacian_1d(n_ilv, dtype=torch.float32, device="cpu")
    r_ilv = rng.standard_normal(n_ilv).astype(np.float32)
    steps = 2 * s
    _ritz_parity(dist_ca_lanczos(A_ilv, r_ilv, s, steps, mesh), A_ilv, r_ilv, s, steps,
                 "natural")
    res_ilv = dist_ca_lanczos(A_ilv, r_ilv, s, steps, mesh, dist_format="ilv")
    _ritz_parity(res_ilv, A_ilv, r_ilv, s, steps, "ilv")
    assert res_ilv.Q.shape == (n_ilv, steps)

    # The general-sparsity engine on an irregular pattern the banded
    # formats reject (offsets +-7 besides the tridiagonal).
    n_g = P * 64
    g = sp.diags([np.full(n_g, 2.0), np.full(n_g - 1, -1.0), np.full(n_g - 1, -1.0),
                  0.1 * rng.random(n_g - 7), 0.1 * rng.random(n_g - 7)],
                 [0, -1, 1, 7, -7]).tocsr()
    g = ((g + g.T) / 2).astype(np.float32)
    A_g = EllMatrix.from_scipy(g, device="cpu")
    r_g = rng.standard_normal(n_g).astype(np.float32)
    res_g = dist_ca_lanczos(DistPell.from_ell(A_g, mesh, s_max=s), r_g, s, steps, mesh)
    _ritz_parity(res_g, A_g, r_g, s, steps, "pell")

    top = np.array([20.0, 22.0, 25.0], np.float32)
    A_r = _planted_diag(P * 128, top)
    cfg = LanczosConfig(s=s, n_wanted=3, tol=1e-4, max_restarts=30)
    r_r = rng.standard_normal(P * 128).astype(np.float32)
    res_r = dist_restarted_ca_lanczos(A_r, r_r, 16, mesh, cfg)
    assert res_r.converged, "restarted: did not converge on the planted spectrum"
    np.testing.assert_allclose(np.sort(res_r.eigs)[::-1], np.sort(top)[::-1], rtol=1e-3)

    top_i = np.array([20.0, 25.0], np.float32)
    for tag, n_i, fmt in (("natural", P * 128, "auto"), ("ilv", P * 1024, "ilv")):
        res_i = dist_impl_restarted_ca_lanczos(
            _planted_diag(n_i, top_i), rng.standard_normal(n_i), 16, mesh,
            n_wanted=2, s=s, tol=1e-5, max_restarts=30, dist_format=fmt)
        assert res_i.converged, f"IRL({tag}): did not converge"
        np.testing.assert_allclose(np.sort(res_i.eigs)[::-1], np.sort(top_i)[::-1],
                                   rtol=1e-3, err_msg=f"IRL({tag}): wrong spectrum")

    checked = ["block step", "natural", "ilv", "pell", "restarted", "irl natural", "irl ilv"]
    if P % 2 == 0 and P >= 4:
        hier = make_hier_mesh(2, P // 2)
        _ritz_parity(dist_ca_lanczos(A_ilv, r_ilv, s, steps, hier), A_ilv, r_ilv, s, steps,
                     "hier-natural")
        _ritz_parity(dist_ca_lanczos(A_ilv, r_ilv, s, steps, hier, dist_format="ilv"),
                     A_ilv, r_ilv, s, steps, "hier-ilv")
        res_h = dist_restarted_ca_lanczos(A_r, r_r, 16, hier, cfg)
        assert res_h.converged, "hier restarted: did not converge"
        checked += ["hier natural", "hier ilv", "hier restarted"]
    return {"ranks": P, "checked": checked}


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> dict:
    """The distributed flagship step on ``n_devices`` ranks with every
    engine held to Ritz parity (module docstring); raises on a mismatch.
    Returns rank 0's record."""
    from ca_lanczos_tpu_torch.parallel.runtime import spawn

    return spawn(_dryrun_rank, n_devices, device, timeout=timeout)[0]
