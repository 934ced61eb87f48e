"""Distributed s-step Lanczos over a ('rows',) mesh.

The Kim–Chronopoulos recurrence (solvers.sstep, reference
sstep_lanczos.m) with row-sharded operands — the BASELINE configs[4]
workload shape ("s-step CA-Lanczos on a large matrix across hosts,
compute/collective overlap").  Per outer iteration the communication is:

* ONE halo exchange inside the distributed matrix-powers kernel
  (one ppermute pair);
* ONE fused all-reduce for the 2s dot products and the small GEMM
  reductions — expressed as plain jnp ops over NamedSharding arrays, so
  GSPMD partitions the elementwise work and inserts the psum.

The host-side s x s coefficient recurrence is shared verbatim with the
single-chip driver via the ops seam of solvers.sstep._sstep_core.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.ops.spmv import DiaMatrix
from ca_lanczos_tpu.parallel.distributed import DistDia, dist_matrix_powers, dist_spmv
from ca_lanczos_tpu.solvers.sstep import SstepResult, _assemble_T, _sstep_core


@jax.jit
def _dots_2s_sharded(P: jax.Array) -> jax.Array:
    """GSPMD computes shard-local partial sums + one psum."""
    s = P.shape[1] - 1
    diag = jnp.sum(P[:, :s] * P[:, :s], axis=0)
    off = jnp.sum(P[:, :s] * P[:, 1 : s + 1], axis=0)
    out = jnp.zeros(2 * s, P.dtype)
    out = out.at[0::2].set(diag)
    return out.at[1::2].set(off)


class _DistOps:
    """Row-sharded device kernels for the s-step recurrence."""

    def __init__(self, Adist: DistDia, mesh: Mesh):
        self.Adist = Adist
        self.mesh = mesh

    def powers(self, p1, s):
        z = jnp.zeros(s, p1.dtype)
        return dist_matrix_powers(self.Adist, p1, s, z, z, self.mesh)

    def dots(self, P):
        return _dots_2s_sharded(P)

    def next_p1(self, Vk, Vkm1, Es, Gs):
        return dist_spmv(self.Adist, Vk[:, -1], self.mesh) - mm(Vkm1, Es) - mm(Vk, Gs)

    def basis_update(self, P, Vk, t):
        return P - mm(Vk, t)


def dist_sstep_lanczos(
    A: DiaMatrix, psi, s: int, m: int, mesh: Mesh
) -> SstepResult:
    """Distributed sStepLanczos (sstep_lanczos.m:14-178); returns the
    block-tridiagonal T and the row-sharded (padded) basis."""
    Adist = DistDia.from_dia(A, mesh, s_max=s)
    psi_np = np.asarray(psi, np.float64)
    r0 = Adist.shard_vector(psi_np.astype(psi_np.dtype), mesh)
    ops = _DistOps(Adist, mesh)
    Vb, E, F, G, _, _ = _sstep_core(None, r0, s, m, ops=ops)
    T = _assemble_T(E, F, G, m, s)
    Q = jnp.concatenate(Vb[:m], axis=1)
    return SstepResult(T=T, Q=Q[: A.n])
