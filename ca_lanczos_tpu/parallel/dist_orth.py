"""Distributed block orthogonalization: TSQR, CholQR, block CGS.

Mesh-native replacements for the reference's tall-skinny QR layer
(tsqr.m:7-12, cholqr.m:3-9, project.m:32-39): the n-dimension is
row-sharded, all reductions are single XLA collectives:

* ``dist_tsqr`` — local thin QR per shard, ``all_gather`` of the P small
  R factors, replicated QR of the stacked (P*m, m) matrix, local Q
  correction.  One collective of P*m*m elements; the classic
  communication-optimal TSQR tree collapsed to one level (P is small,
  and the all-gather is already a tree/ring in the collective library).
* ``dist_cholqr`` — Gram matrix via ``psum``, replicated Cholesky, local
  triangular solve.  2x fewer flops than TSQR, half the stability (used
  exactly like cholqr.m: an alternative normalizer).
* ``dist_project`` — block classical Gram-Schmidt with ``psum``-reduced
  Gram products (the distributed form of project.m:32-39), fixed two
  passes (BCGS2) so the step stays branch-free under jit; the
  data-dependent single/double-pass choice of the host path
  (projectAndNormalize.m:43-57) is deliberately replaced by the
  always-double-pass variant, which is what a fixed-shape jitted step wants
  and is at least as accurate.

All functions run INSIDE ``shard_map`` (they operate on local shards and
use ``psum``/``all_gather`` over the mesh row axes); compose them into a
jitted step with ``jax.shard_map`` — see ``parallel.step``.

**Hierarchical meshes** (``mesh.make_hier_mesh``, axes ``(HOST, CHIP)``):
every function takes the mesh's row-axis handle via ``axes`` and the
reductions become explicitly two-level —

* ``psum_rows`` reduces over the chip axis first (intra-host all-reduce)
  and then over the host axis (inter-host all-reduce of the
  already-reduced partials), the classic hierarchical all-reduce tree;
* ``local_tsqr`` builds a two-level R-factor tree: chip-level stacked-R
  QR (C*m x m, intra-host) then host-level (H*m x m, inter-host) — the
  inter-host reduction volume drops from P*m^2 to H*m^2 and the
  replicated small QR shrinks.

The flat ``('rows',)`` path is unchanged.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.parallel.mesh import ROWS, RowAxes


def _hier(axes: RowAxes) -> bool:
    """True for a hierarchical (host, chip) row-axis handle."""
    return isinstance(axes, tuple) and len(axes) > 1


def psum_rows(x: jax.Array, axes: RowAxes = ROWS) -> jax.Array:
    """All-reduce over the mesh row axes.  Hierarchical meshes reduce the
    innermost (chip, intra-host) axis first, then the host axis — each
    inter-host message carries the host's already-reduced partial, so
    inter-host traffic is one partial per host instead of one per chip."""
    if _hier(axes):
        for a in reversed(axes):
            x = lax.psum(x, a)
        return x
    return lax.psum(x, axes)


def _stack_qr(R: jax.Array, axis_name: str) -> Tuple[jax.Array, jax.Array]:
    """One TSQR tree level over ``axis_name``: slot-place this rank's R
    into a (size*m, m) stack, psum (statically replicated all-gather),
    QR, and return (my Q-correction slice, next-level R)."""
    m = R.shape[1]
    size = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    stacked = jnp.zeros((size * m, m), R.dtype)
    stacked = lax.dynamic_update_slice_in_dim(stacked, R, idx * m, axis=0)
    stacked = lax.psum(stacked, axis_name)
    Qs, Rs = jnp.linalg.qr(stacked, mode="reduced")
    return lax.dynamic_slice_in_dim(Qs, idx * m, m, axis=0), Rs


def local_tsqr(X_local: jax.Array, axes: RowAxes = ROWS) -> Tuple[jax.Array, jax.Array]:
    """TSQR across the row axes: X_local (n_local, m) -> (Q_local, R).

    R is replicated and has a non-negative diagonal (sign-fix parity with
    tsqr.m:9-11).  Call inside shard_map.

    Flat mesh: one R-reduction level (P*m x m).  Hierarchical mesh: the
    communication-optimal two-level tree — chip level stays inside a
    host, host level moves only H small R factors between hosts.
    """
    Q1, R1 = jnp.linalg.qr(X_local, mode="reduced")  # (n_local, m), (m, m)
    if _hier(axes):
        host_ax, chip_ax = axes[0], axes[-1]
        Q2_mine, R2 = _stack_qr(R1, chip_ax)   # intra-host level
        Q3_mine, R = _stack_qr(R2, host_ax)    # inter-host level
        Q_corr = mm(Q2_mine, Q3_mine)
    else:
        Q_corr, R = _stack_qr(R1, axes)
    # Sign fix: diag(R) >= 0.
    sgn = jnp.where(jnp.diag(R) < 0, -1.0, 1.0).astype(R.dtype)
    R = sgn[:, None] * R
    Q_corr = Q_corr * sgn[None, :]
    return mm(Q1, Q_corr), R


def local_cholqr(
    X_local: jax.Array, mp: bool = False, axes: RowAxes = ROWS
) -> Tuple[jax.Array, jax.Array]:
    """CholQR across the row axes (cholqr.m:3-9): G = psum(X^T X),
    R = chol(G), Q = X R^{-1}.  Call inside shard_map.

    mp: accumulate the Gram psum, Cholesky, and triangular solve in
    float64 while X (and the returned Q) stay in the storage dtype —
    the distributed form of ops.qr.cholqr_mp (OrthParams.
    mixed_precision).  The f64 Gram is the accuracy lever: the psum'd
    X^T X in f32 loses ~2^-24 relative, the f32 flagship's hardware
    eigenvalue-error floor.  R returns float64 so the host T recovery
    keeps full precision."""
    from ca_lanczos_tpu.ops.qr import _chol_safe

    if mp and X_local.dtype != jnp.float64:
        Xw = X_local.astype(jnp.float64)
        G = psum_rows(mm(Xw.T, Xw), axes)
        R = _chol_safe(G).conj().T
        Q = lax.linalg.triangular_solve(
            R, Xw, left_side=False, lower=False
        ).astype(X_local.dtype)
        return Q, R
    G = psum_rows(mm(X_local.T, X_local), axes)
    R = _chol_safe(G).conj().T
    Q = lax.linalg.triangular_solve(R, X_local, left_side=False, lower=False)
    return Q, R


def local_cholqr2(
    X_local: jax.Array, mp: bool = False, axes: RowAxes = ROWS
) -> Tuple[jax.Array, jax.Array]:
    """Two distributed CholQR passes — the throughput normalizer (one
    psum'd Gram per pass instead of a Householder panel sequence; see
    config.QrMethod).  Valid for cond(X) < ~eps^{-1/2}."""
    Q1, R1 = local_cholqr(X_local, mp, axes)
    Q2, R2 = local_cholqr(Q1, mp, axes)
    return Q2, mm(R2, R1)


def local_tsqr_mp(X_local: jax.Array, axes: RowAxes = ROWS) -> Tuple[jax.Array, jax.Array]:
    """local_tsqr with the factorization in float64; Q returns in X's
    dtype, R stays float64 (distributed ops.qr.tsqr_mp)."""
    Q, R = local_tsqr(X_local.astype(jnp.float64), axes)
    return Q.astype(X_local.dtype), R


def local_qr(
    X_local: jax.Array, qr_method: str = "tsqr", mp: bool = False,
    axes: RowAxes = ROWS,
):
    """Dispatch on config.QrMethod value (+ OrthParams.mixed_precision)."""
    from ca_lanczos_tpu.config import QrMethod

    mp = mp and X_local.dtype != jnp.float64
    if QrMethod(qr_method) == QrMethod.CHOLQR2:
        return local_cholqr2(X_local, mp, axes)
    return local_tsqr_mp(X_local, axes) if mp else local_tsqr(X_local, axes)


def local_qr_safe(
    X_local: jax.Array,
    qr_method: str = "tsqr",
    key: jax.Array = None,
    rank_tol: float = 1.0e-12,
    mp: bool = False,
    axes: RowAxes = ROWS,
):
    """Rank-revealing local_qr with masked fixed-shape null-space
    randomization — the in-jit distributed form of the reference's
    ``randomizeNullSpace`` (normalize.m:28-51).

    Deficient directions (sigma_i <= rank_tol * sigma_1; the reference
    uses 1e-8 at normalize.m:17-24, but a monomial powers block is
    legitimately 1e-8-conditioned, so true-breakdown detection here sits
    near roundoff instead) are counted into the returned ``rank``; the
    RANDOMIZED basis refresh fires only on CATASTROPHIC breakdown
    (rank <= 1, i.e. the start vector was an invariant direction).
    Merely ill-conditioned blocks — a restart from a nearly-converged
    Ritz vector makes sigma_min/sigma_1 ~ (residual * basis condition),
    down to 1e-13..1e-15 — pass through unrefreshed: Householder QR
    keeps range(X) in the leading columns and the pinv T recovery
    regularizes the small solves, whereas a wholesale refresh would
    destroy the Q/R pairing and wipe the cycle's refinement (observed
    as a convergence stall at ~1e-5 residuals).
    Returns (Q, R, rank).
    """
    m = X_local.shape[1]
    # mp composes: the factorization R (the T-recovery input) keeps its
    # f64 Gram accumulation in safe mode too; the refresh path below is
    # randomization plumbing and stays in storage dtype.
    Q, R = local_qr(X_local, qr_method, mp, axes)
    # Numerical rank via SVD of the small replicated R, exactly like the
    # reference (normalize.m:14-24): singular DIRECTIONS, not columns —
    # an unpivoted QR can leak range components into its garbage columns,
    # so diagonal-of-R tests would lose part of range(X).
    U, S, _ = jnp.linalg.svd(R)
    bad = S <= rank_tol * S[0]  # replicated; sorted, so bad is a suffix
    rank = m - jnp.sum(bad)

    idx = lax.axis_index(axes)  # linearized on hierarchical meshes
    k = jax.random.fold_in(key, idx)
    rnd = jax.random.normal(k, X_local.shape, X_local.dtype)
    # keep the refresh path in storage dtype (mp leaves R f64)
    Qrot = mm(Q, U.astype(Q.dtype))  # leading `rank` cols span range(X)
    Qgood = jnp.where(bad[None, :], 0.0, Qrot)
    Y = jnp.where(bad[None, :], rnd, Qrot)
    for _ in range(2):  # masked CGS: only the replaced columns move
        G = local_gram(Qgood, Y, axes=axes)
        Y = jnp.where(bad[None, :], Y - mm(Qgood, G), Y)
    Q2, _ = local_qr(Y, qr_method, axes=axes)
    # Left-to-right QR keeps the (already orthonormal) surviving columns
    # and completes the replaced ones against them.  On breakdown the
    # returned Q no longer pairs columnwise with R (the basis has been
    # refreshed); R is returned unchanged so callers can regularize their
    # small solves, exactly as with the reference's randomizeNullSpace.
    severe = rank <= 1  # catastrophic only — see docstring
    Q_out = jnp.where(severe, Q2, Q)
    return Q_out, R, rank


def local_gram(
    Q_local: jax.Array, X_local: jax.Array, mp: bool = False,
    axes: RowAxes = ROWS,
) -> jax.Array:
    """Replicated Gram product R = Q^H X via psum (two-level on
    hierarchical meshes).  Call inside shard_map.  mp: accumulate in
    float64 (returns float64)."""
    if mp and X_local.dtype != jnp.float64:
        return psum_rows(
            mm(Q_local.astype(jnp.float64).conj().T,
               X_local.astype(jnp.float64)),
            axes,
        )
    return psum_rows(mm(Q_local.conj().T, X_local), axes)


def local_project(
    Q_local: jax.Array, X_local: jax.Array, passes: int = 2, mp: bool = False,
    axes: RowAxes = ROWS,
):
    """Block CGS of X against orthonormal Q with ``passes`` fixed passes
    (distributed project.m:32-39 with the BCGS2 second pass made
    unconditional).  Returns (Y_local, R accumulated).

    mp: Gram products and corrections in float64 (distributed
    ops.orth._proj_block_mp); Y returns in X's dtype, R in float64."""
    mp = mp and X_local.dtype != jnp.float64
    rdtype = jnp.float64 if mp else X_local.dtype
    R = jnp.zeros((Q_local.shape[1], X_local.shape[1]), rdtype)
    Y = X_local
    for _ in range(passes):
        Rp = local_gram(Q_local, Y, mp, axes)
        if mp:
            Y = (
                Y.astype(jnp.float64) - mm(Q_local.astype(jnp.float64), Rp)
            ).astype(X_local.dtype)
        else:
            Y = Y - mm(Q_local, Rp)
        R = R + Rp
    return Y, R


def local_norm(x_local: jax.Array, axes: RowAxes = ROWS) -> jax.Array:
    """Global 2-norm of a row-sharded vector/multivector (per column)."""
    return jnp.sqrt(psum_rows(jnp.sum(jnp.abs(x_local) ** 2, axis=0), axes))
