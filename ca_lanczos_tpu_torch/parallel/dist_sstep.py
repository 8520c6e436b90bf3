"""Distributed s-step Lanczos.

Counterpart of ``ca_lanczos_tpu/parallel/dist_sstep.py``: the
Kim–Chronopoulos recurrence (``solvers.sstep``, sstep_lanczos.m) with
row-sharded operands, BASELINE.json configs[4]'s workload ("s-step
CA-Lanczos on a large matrix across hosts").  Per outer iteration a rank
pays ONE halo exchange inside the matrix powers (K1 on its halo-padded
DIA shard, or K2 steps where K1's plan says "steps") and ONE all-reduce
of the 2s dot products (summed as the JAX package sums them: the
recurrence amplifies their rounding, so the order is kept); ``next_p1``'s product is ``dist_spmv`` (K2).
The host s x s recurrence is the single-card driver's, through the ops
seam of ``solvers.sstep._sstep_core``; every rank repeats it on the same
all-reduced numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ca_lanczos_tpu_torch.parallel.dist_orth import local_norm, psum_rows
from ca_lanczos_tpu_torch.parallel.distributed import DistDia, dist_matrix_powers, dist_spmv
from ca_lanczos_tpu_torch.parallel.mesh import Mesh
from ca_lanczos_tpu_torch.solvers.sstep import SstepResult, _assemble_T, _sstep_core


class _DistOps:
    """The s-step recurrence's device operations on this rank's rows."""

    def __init__(self, Adist: DistDia, mesh: Mesh):
        self.Adist = Adist
        self.mesh = mesh

    def norm(self, r0):
        return local_norm(r0, self.mesh)

    def powers(self, p1, s):
        return dist_matrix_powers(self.Adist, p1.contiguous(), s, None, None, self.mesh)

    def dots(self, P):
        """The 2s dot products as the JAX package's ``_dots_2s_sharded``
        forms them: the rank's column sums of P[:, i] P[:, i] and P[:, i]
        P[:, i+1], added over the ranks in one all-reduce."""
        s = P.shape[1] - 1
        part = torch.stack([(P[:, :s] * P[:, :s]).sum(0), (P[:, :s] * P[:, 1:]).sum(0)], 1)
        return psum_rows(part.reshape(-1), self.mesh).cpu().numpy().astype(np.float64)

    def next_p1(self, Vk, Vkm1, Es, Gs):
        return dist_spmv(self.Adist, Vk[:, -1], self.mesh) - Vkm1 @ Es - Vk @ Gs

    def basis_update(self, P, Vk, t):
        return P - Vk @ t


def dist_sstep_lanczos(A, psi, s: int, m: int, mesh: Mesh) -> SstepResult:
    """Distributed sStepLanczos (sstep_lanczos.m:14-178) of a DiaMatrix
    (every rank passes the same; psi is the global start vector, taken as
    float64 as in the JAX package).  T is replicated; Q holds this rank's
    rows (n_local, s*m), as every distributed driver's state does (gather
    with ``comm.all_gather``)."""
    from ca_lanczos_tpu_torch.parallel.driver import _as_host

    Adist = DistDia.from_dia(A, mesh, s_max=s)
    r0 = Adist.shard_vector(np.asarray(_as_host(psi), np.float64))
    Vb, E, F, G, _, _ = _sstep_core(None, r0, s, m, ops=_DistOps(Adist, mesh))
    T = _assemble_T(E, F, G, m, s)
    return SstepResult(T=T, Q=torch.cat(Vb[:m], dim=1))
