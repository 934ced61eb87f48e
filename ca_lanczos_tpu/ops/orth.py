"""Block orthogonalization: project / normalize / project_and_normalize.

This is the L1 "BLAS-3 QR layer" of the reference (project.m,
normalize.m, projectAndNormalize.m), restructured for an accelerator:

* The heavy ops — block Gram products ``Q^H X`` and the tall-skinny QR —
  are jitted device GEMMs/QRs.
* The small R factors come back to host as float64 numpy arrays, where all
  O(s^2) control logic (rank decisions, second-pass triggers, the Tk
  recurrence in the drivers) runs.

Semantics mirrored from the reference:

* ``project`` — block classical Gram-Schmidt, sequential over Q blocks
  (project.m:32-39), with an optional second pass.  NOTE the reference's
  second-pass trigger at project.m:44-46 fires when *no* column lost more
  than half its norm (``max(rho*normBefore - normAfter) < 0``) — the
  conventional BCGS2 criterion inverted.  We reproduce it by default
  (OrthParams.reference_second_pass) and offer the conventional test.
* ``normalize`` — TSQR + SVD rank check (sigma_i <= tol * sigma_1,
  tol=1e-8) with optional null-space randomization (normalize.m:3-51).
* ``project_and_normalize`` — project then rank-revealing normalize, with
  a full second pass if any column norm of the normalization R dropped by
  more than 50% relative to the input column norm
  (projectAndNormalize.m:10,43-84); R blocks accumulate across passes
  while the normalization R is replaced (projectAndNormalize.m:65,71-73).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.config import OrthParams, QrMethod
from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.ops.qr import cholqr2, cholqr2_mp, tsqr, tsqr_mp

DEFAULT_ORTH_PARAMS = OrthParams()


def _qr(X: jax.Array, params: OrthParams):
    mp = params.mixed_precision and X.dtype != jnp.float64
    if QrMethod(params.qr_method) == QrMethod.CHOLQR2:
        return cholqr2_mp(X) if mp else cholqr2(X)
    return tsqr_mp(X) if mp else tsqr(X)


@jax.jit
def _proj_block(Q: jax.Array, X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """One CGS block step: R = Q^H X; X <- X - Q R."""
    with jax.named_scope("block_cgs"):
        R = mm(Q.conj().T, X)
        return X - mm(Q, R), R


@jax.jit
def _proj_block_mp(Q: jax.Array, X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """CGS block step with the Gram product and correction in float64
    (OrthParams.mixed_precision); the updated block returns in X's dtype."""
    with jax.named_scope("block_cgs_mp"):
        Qw = Q.astype(jnp.float64)
        Xw = X.astype(jnp.float64)
        R = mm(Qw.conj().T, Xw)
        return (Xw - mm(Qw, R)).astype(X.dtype), R


@jax.jit
def _col_norms(X: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.sum(jnp.abs(X) ** 2, axis=0))


def _as_2d(X: jax.Array) -> Tuple[jax.Array, bool]:
    if X.ndim == 1:
        return X[:, None], True
    return X, False


def project(
    Q_blocks: Sequence[jax.Array],
    X: jax.Array,
    reorth: bool = False,
    params: OrthParams = DEFAULT_ORTH_PARAMS,
) -> Tuple[jax.Array, List[np.ndarray]]:
    """Project X against a list of orthonormal blocks (project.m:7-58).

    Returns (Y, R_blocks) with Y on device and R blocks as host float64;
    when ``reorth`` and the trigger fires, R blocks include the second
    pass' coefficients (R{i} += R2{i}, project.m:47-55).
    """
    X2, was_vec = _as_2d(X)
    m = X2.shape[1]

    def _is_empty(Q) -> bool:
        return Q is None or Q.size == 0

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
        if params.mixed_precision and X2.dtype != jnp.float64
        else _proj_block
    )
    for Q in Q_blocks:
        if _is_empty(Q):
            R_blocks.append(np.zeros((0, m)))
            continue
        Q2, _ = _as_2d(Q)
        Y, R = proj(Q2, Y)
        R_blocks.append(np.asarray(R))

    if reorth:
        norm_after = _col_norms(Y)
        diff = np.asarray(params.reorth_tol * norm_before - norm_after)
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
                Q2, _ = _as_2d(Q)
                Y, R2 = proj(Q2, Y)
                R_blocks[i] = R_blocks[i] + np.asarray(R2)

    if was_vec:
        Y = Y[:, 0]
    return Y, R_blocks


def normalize(
    X: jax.Array,
    randomize: bool = False,
    params: OrthParams = DEFAULT_ORTH_PARAMS,
    key: Optional[jax.Array] = None,
    Q_against: Sequence[jax.Array] = (),
) -> Tuple[jax.Array, np.ndarray, int]:
    """Rank-revealing orthonormalization (normalize.m:3-51).

    TSQR, then SVD of the small R; numerical rank is the count of singular
    values > rank_tol * sigma_1.  With ``randomize`` and a rank-deficient
    block, the null-space columns are replaced by random vectors,
    projected against the full-rank columns (and any ``Q_against``
    blocks), and re-orthonormalized (normalize.m:38-51).

    Returns (Q devicearray, R float64 numpy, rank).
    """
    X2, was_vec = _as_2d(X)
    m = X2.shape[1]
    Q, R = _qr(X2, params)
    R_np = np.asarray(R)
    U, S, Wh = np.linalg.svd(R_np)
    abs_tol = params.rank_tol * (S[0] if S.size else 0.0)
    rank = int(np.sum(S > abs_tol))

    if rank == m or not randomize:
        if was_vec:
            Q = Q[:, 0]
        return Q, R_np, rank

    # Randomize the null space (normalize.m:28-31,38-51).
    R_np = np.diag(S) @ Wh  # R = S * W'
    Q = mm(Q, jnp.asarray(U, dtype=Q.dtype))
    n = Q.shape[0]
    n_null = m - rank
    if key is None:
        key = jax.random.PRNGKey(np.random.SeedSequence().entropy % (2**63))
    rnd = jax.random.uniform(key, (n, n_null), dtype=jnp.real(Q).dtype).astype(Q.dtype)
    full_rank_cols = Q[:, :rank]
    blocks = [full_rank_cols] + [b for b in Q_against if b is not None and b.size > 0]
    rnd, _ = project(blocks, rnd)
    rnd_q, _ = _qr(rnd, params)
    Q = Q.at[:, rank:].set(rnd_q)
    if was_vec:
        Q = Q[:, 0]
    return Q, R_np, rank


@dataclasses.dataclass
class PNResult:
    """Result of project_and_normalize.

    Q: orthonormalized block (device array).
    R_blocks: projection coefficients, one per input Q block (host f64).
    R: the normalization R factor from the *last* normalize pass (host
       f64) — the reference returns this at RZ{numBlocksQ+1}
       (projectAndNormalize.m:27,65).
    rank: numerical rank from the last normalize.
    second_pass: whether the 50%-drop trigger fired.
    """

    Q: jax.Array
    R_blocks: List[np.ndarray]
    R: np.ndarray
    rank: int
    second_pass: bool


def project_and_normalize(
    Q_blocks: Sequence[jax.Array],
    X: jax.Array,
    reorth: bool = True,
    params: OrthParams = DEFAULT_ORTH_PARAMS,
    randomize: bool = False,
    key: Optional[jax.Array] = None,
) -> PNResult:
    """Block CGS + rank-revealing QR with conditional second pass.

    (projectAndNormalize.m:3-90.)
    """
    X2, was_vec = _as_2d(X)

    norms_before = np.asarray(_col_norms(X2)) if reorth else None

    Y, RY = project(Q_blocks, X2, reorth=False, params=params)
    QY, R1, rank = normalize(Y, randomize=randomize, params=params, key=key, Q_against=Q_blocks)

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
        QZ, R2, rank2 = normalize(Z, randomize=randomize, params=params, key=key, Q_against=Q_blocks)
        # Accumulate projection coefficients across passes
        # (projectAndNormalize.m:71-73); normalization R is replaced.
        R_blocks = [a + b for a, b in zip(RY, RZ)] if RY else RZ
        Q_out, R_out, rank_out = QZ, R2, rank2

    if was_vec:
        Q_out = Q_out[:, 0]
    return PNResult(Q=Q_out, R_blocks=R_blocks, R=R_out, rank=rank_out, second_pass=second)
