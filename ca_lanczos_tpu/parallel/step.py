"""The jitted distributed CA-Lanczos block step.

One call = one outer CA iteration's device work, compiled to a single XLA
program over the ``('rows',)`` mesh:

    halo exchange (ppermute)  ->  s local SpMVs        [matrix powers]
    psum Gram + 2x block CGS  ->  TSQR (all_gather)    [block orth]

Everything the reference does per block in MATLAB dense algebra
(ca_lanczos.m:174-198) runs here as one fused step; the O(s^2) T-assembly
from the returned R factors stays on host (solvers._block).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec

from ca_lanczos_tpu.parallel.dist_orth import local_project, local_qr
from ca_lanczos_tpu.parallel.dist_ell import DistEll, _ell_powers_local
from ca_lanczos_tpu.parallel.distributed import DistDia, _powers_local
from ca_lanczos_tpu.parallel.mesh import ROWS, RowAxes, row_axes, row_spec


def partition_operator(A, mesh: Mesh, s_max: int):
    """Partition a host operator for row-sharded distribution.

    DiaMatrix -> DistDia; EllMatrix -> DistEll; BsrMatrix -> DistBsr; an
    already-distributed operator passes through.  Shared by every dist
    driver so they agree on format semantics (reference seam: SpMV.m:1-9
    takes any format)."""
    from ca_lanczos_tpu.ops.bsr import BsrMatrix
    from ca_lanczos_tpu.ops.spmv import DiaMatrix, EllMatrix
    from ca_lanczos_tpu.parallel.dist_bsr import DistBsr

    if isinstance(A, (DistDia, DistEll, DistBsr)):
        return A
    if isinstance(A, BsrMatrix):
        return DistBsr.from_bsr(A, mesh, s_max=s_max)
    if isinstance(A, EllMatrix):
        return DistEll.from_ell(A, mesh, s_max=s_max)
    if isinstance(A, DiaMatrix):
        return DistDia.from_dia(A, mesh, s_max=s_max)
    raise TypeError(
        f"cannot distribute operator of type {type(A).__name__}; pass a "
        "DiaMatrix, EllMatrix or BsrMatrix (route raw matrices via "
        "parallel.auto.route_dist_operator)"
    )


def _local_powers_fn(A, s: int, axes: RowAxes = ROWS):
    """Uniform (operand_blocks..., x_local, diag, sub) -> (n_local, s+1)
    powers closure for DistDia / DistEll / DistBsr shards, plus the
    operand arrays to thread through shard_map."""
    from ca_lanczos_tpu.parallel.dist_bsr import DistBsr, _bsr_powers_local
    from ca_lanczos_tpu.parallel.distributed import (
        check_s_bound, dia_powers_statics,
    )

    check_s_bound(A, s)

    if isinstance(A, DistBsr):
        def body_bsr(v_block, c_block, x_local, dg, sb):
            return _bsr_powers_local(
                v_block[0], c_block[0], x_local, dg, sb,
                halo_b=A.halo_b, bm=A.bm, n_shards=A.n_shards, s=s,
                axes=axes,
            )

        return body_bsr, (A.vals, A.cols)

    if isinstance(A, DistEll):
        def body_ell(v_block, c_block, x_local, dg, sb):
            return _ell_powers_local(
                v_block[0], c_block[0], x_local, dg, sb,
                halo=A.halo, n_shards=A.n_shards, s=s, periodic=A.periodic,
                axes=axes,
            )

        return body_ell, (A.vals, A.cols)

    statics = dia_powers_statics(A, s, axes)

    def body_dia(data_block, x_local, dg, sb):
        return _powers_local(data_block[0], x_local, dg, sb, **statics)

    return body_dia, (A.data,)


def newton_coeffs(Bk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Three-term recurrence coefficients (diag, sup) from a change-of-basis
    matrix Bk ((s+1) x s, unit subdiagonal): V[:,k+1] = (A - diag[k]) V[:,k]
    - sup[k] V[:,k-1].  Monomial Bk gives zeros (ca_lanczos.m:63-65)."""
    Bk = np.asarray(Bk, dtype=np.float64)
    s = Bk.shape[1]
    diag = np.diagonal(Bk)[:s].copy()
    sup = np.zeros(s)
    if s > 1:
        sup[1:] = np.diagonal(Bk, 1)[: s - 1]
    return diag, sup


@partial(jax.jit, static_argnames=("s", "mesh", "qr_method", "mp"))
def dist_first_block(
    A, q: jax.Array, diag: jax.Array, sub: jax.Array, s: int, mesh: Mesh,
    qr_method: str = "tsqr", mp: bool = False,
):
    """First CA block: V = powers(q); [Q, R] = TSQR(V)
    (ca_lanczos.m:176-182).  A is a distributed operator; returns
    (Q (n, s+1) sharded, R (s+1, s+1)).  mp: float64 Gram/R reductions
    (OrthParams.mixed_precision) while the basis stays f32."""
    axes = row_axes(mesh)
    powers, operands = _local_powers_fn(A, s, axes)

    def body(*args):
        *op_blocks, x_local, dg, sb = args
        V = powers(*op_blocks, x_local, dg, sb)
        Q, R = local_qr(V, qr_method, mp, axes)
        return Q, R

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple([row_spec(mesh)] * (len(operands) + 1)) + (PartitionSpec(), PartitionSpec()),
        out_specs=(row_spec(mesh), PartitionSpec()),
    )(*operands, q, diag, sub)


@partial(jax.jit, static_argnames=("s", "mesh", "qr_method", "mp"))
def dist_ca_block(
    A, Q_prev: jax.Array, diag: jax.Array, sub: jax.Array, s: int, mesh: Mesh,
    qr_method: str = "tsqr", mp: bool = False,
):
    """One CA block step k>1 (ca_lanczos.m:185-214 device portion).

    Q_prev: previous block's s+1 orthonormal columns (row-sharded); its
    last column seeds the next matrix-powers block (ca_lanczos.m:170-174).
    Returns (Q_new (n, s) sharded, Rkk (s+1, s), R (s, s)) with Rkk the
    CGS coefficients against Q_prev and R the TSQR factor — exactly the
    inputs of the Tk recurrence (solvers._block.block_T).
    """

    axes = row_axes(mesh)
    powers, operands = _local_powers_fn(A, s, axes)

    def body(*args):
        *op_blocks, Qp_local, dg, sb = args
        q_local = Qp_local[:, -1]
        V = powers(*op_blocks, q_local, dg, sb)
        X = V[:, 1:]
        Y, Rkk = local_project(Qp_local, X, passes=2, mp=mp, axes=axes)
        Q_new, R = local_qr(Y, qr_method, mp, axes)
        return Q_new, Rkk, R

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple([row_spec(mesh)] * (len(operands) + 1)) + (PartitionSpec(), PartitionSpec()),
        out_specs=(row_spec(mesh), PartitionSpec(), PartitionSpec()),
    )(*operands, Q_prev, diag, sub)
