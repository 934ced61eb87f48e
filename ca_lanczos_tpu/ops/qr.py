"""Tall-skinny QR factorizations (L1 layer).

* ``tsqr`` — thin QR with the sign convention diag(R) >= 0
  (reference: tsqr.m:7-12).  Single-device version; the distributed
  TSQR (local QR + gathered R-stack reduction) lives in
  ``ca_lanczos_tpu.parallel``.  Numerically the most robust normalizer;
  Householder QR is a sequence of panel updates, so CholQR2 (one Gram
  matmul per pass) is the throughput choice (config.QrMethod).
* ``cholqr`` — Cholesky QR (reference: cholqr.m:3-9).  One Gram matmul +
  replicated small Cholesky + triangular solve; the cheapest
  communication pattern on a mesh and the fastest single-chip path when
  the block is well-conditioned.
* ``cholqr2`` — two Cholesky-QR passes with an escalating diagonal shift
  (shifted CholQR, Fukaya et al.) applied only when the Cholesky breaks
  down, so well-conditioned blocks keep machine-level orthogonality and
  rank-deficient blocks degrade gracefully instead of producing NaNs.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ca_lanczos_tpu.ops.precision import mm


def _sign_fix(Q: jax.Array, R: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Flip signs so diag(R) >= 0 (tsqr.m:9-11); sign(0) treated as +1."""
    d = jnp.sign(jnp.real(jnp.diagonal(R)))
    d = jnp.where(d == 0, 1.0, d).astype(R.dtype)
    return Q * d[None, :], R * d[:, None]


@jax.jit
def tsqr(X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Thin QR of X (n, m), n >= m, with diag(R) >= 0."""
    with jax.named_scope("tsqr"):
        Q, R = jnp.linalg.qr(X, mode="reduced")
        return _sign_fix(Q, R)


def _chol_safe(G: jax.Array) -> jax.Array:
    """Lower Cholesky of a PSD Gram matrix with escalating diagonal shifts
    on breakdown: 0 -> few-ulp (shifted CholQR) -> 1% of trace.  All three
    factorizations are m x m (trivial cost); the first finite one wins, so
    healthy inputs are untouched."""
    m = G.shape[0]
    eps = jnp.finfo(jnp.real(G).dtype).eps
    tr = jnp.trace(jnp.real(G)).astype(G.dtype)
    eye = jnp.eye(m, dtype=G.dtype)
    L0 = jnp.linalg.cholesky(G)
    L1 = jnp.linalg.cholesky(G + (11.0 * (m + 1) * eps * tr) * eye)
    L2 = jnp.linalg.cholesky(G + (0.01 * tr + eps) * eye)
    bad0 = jnp.any(jnp.isnan(L0))
    bad1 = jnp.any(jnp.isnan(L1))
    return jnp.where(bad0, jnp.where(bad1, L2, L1), L0)


@jax.jit
def cholqr(X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Cholesky QR: G = X^H X, R = chol(G) (upper), Q = X R^{-1}."""
    G = mm(X.conj().T, X)
    L = _chol_safe(G)  # lower
    R = L.conj().T
    # Q = X R^{-1}  <=>  R^T Q^T = X^T (no conjugation: (QR)^T = R^T Q^T)
    Qt = jax.scipy.linalg.solve_triangular(R.T, X.T, lower=True)
    return Qt.T, R


@jax.jit
def cholqr2(X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """CholQR2: two safe Cholesky-QR passes.

    Not in the reference; the high-throughput orthogonalizer (Gram
    matmuls, no Householder sequential dependency).  Valid
    to machine orthogonality for cond(X) < ~eps^{-1/2}; beyond that the
    escalating shifts keep the result finite and the drivers' rank
    checks / conditional reorthogonalization take over.
    """
    Q1, R1 = cholqr(X)
    Q2, R2 = cholqr(Q1)
    return Q2, mm(R2, R1)


@jax.jit
def tsqr_mp(X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """tsqr with the factorization in float64; Q returns in X's dtype,
    R stays float64 (OrthParams.mixed_precision)."""
    Q, R = tsqr(X.astype(jnp.float64))
    return Q.astype(X.dtype), R


# Mixed-precision reductions above this many rows run CHUNKED so the
# f64 promotion of an (n, m) block never materializes (at the 10M-row
# north-star scale a promoted 48-vector basis is 4.2 GB — it OOMed the
# fused flagship).  The chunk results are mathematically identical up
# to f64 summation order.
_MP_CHUNK_ROWS = 1 << 21


def _mp_chunk_shape(n: int):
    """(chunks, rows_per_chunk) with chunks*rows == n, or None to run
    direct.  Prefers the smallest chunk count that divides n; a prime n
    falls back to direct (the corpus/benchmarks use power-of-two-ish n,
    and correctness never depends on chunking)."""
    if n <= _MP_CHUNK_ROWS:
        return None
    c0 = -(-n // _MP_CHUNK_ROWS)
    for c in range(c0, min(4 * c0, n) + 1):
        if n % c == 0:
            return c, n // c
    return None


def gram_f64(X: jax.Array, Y: jax.Array) -> jax.Array:
    """X^H Y accumulated in float64 without materializing promoted
    copies of the (n, .) operands: row-chunked scan, f64 temps of one
    chunk only."""
    ck = _mp_chunk_shape(X.shape[0])
    if ck is None:
        return mm(X.astype(jnp.float64).conj().T, Y.astype(jnp.float64))
    c, L = ck
    Xr = X.reshape(c, L, X.shape[1])
    Yr = Y.reshape(c, L, Y.shape[1])
    from jax import lax

    def body(acc, xy):
        xc, yc = xy
        return acc + mm(xc.astype(jnp.float64).conj().T, yc.astype(jnp.float64)), None

    G0 = jnp.zeros((X.shape[1], Y.shape[1]), jnp.float64)
    G, _ = lax.scan(body, G0, (Xr, Yr))
    return G


def sub_proj_f64(X: jax.Array, Q: jax.Array, R: jax.Array) -> jax.Array:
    """(X - Q R) computed in float64 per row chunk, returned in X's
    storage dtype."""
    ck = _mp_chunk_shape(X.shape[0])
    if ck is None:
        return (
            X.astype(jnp.float64) - mm(Q.astype(jnp.float64), R)
        ).astype(X.dtype)
    c, L = ck
    Xr = X.reshape(c, L, X.shape[1])
    Qr = Q.reshape(c, L, Q.shape[1])
    from jax import lax

    def body(_, xq):
        xc, qc = xq
        out = (xc.astype(jnp.float64) - mm(qc.astype(jnp.float64), R)).astype(X.dtype)
        return None, out

    _, out = lax.scan(body, None, (Xr, Qr))
    return out.reshape(X.shape)


def rsolve_f64(X: jax.Array, R: jax.Array) -> jax.Array:
    """X R^{-1} with the triangular solve in float64 per row chunk,
    returned in X's storage dtype."""
    ck = _mp_chunk_shape(X.shape[0])
    if ck is None:
        Qt = jax.scipy.linalg.solve_triangular(
            R.T, X.astype(jnp.float64).T, lower=True
        )
        return Qt.T.astype(X.dtype)
    c, L = ck
    Xr = X.reshape(c, L, X.shape[1])
    from jax import lax

    def body(_, xc):
        qt = jax.scipy.linalg.solve_triangular(
            R.T, xc.astype(jnp.float64).T, lower=True
        )
        return None, qt.T.astype(X.dtype)

    _, out = lax.scan(body, None, Xr)
    return out.reshape(X.shape)


@jax.jit
def cholqr_mp(X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """cholqr with the Gram product, Cholesky, and triangular solve in
    float64 while X (and the returned Q) stay in the storage dtype.

    The f64 Gram is the accuracy lever: G = X^H X in f32 loses ~2^-24
    relative, which is exactly the eigenvalue error floor the f32
    flagship showed; promoting the O(n m^2) reduction fixes
    it at negligible cost next to the SpMV stream.  Above _MP_CHUNK_ROWS
    the reductions run row-chunked (see gram_f64) so no f64 copy of X is
    ever resident.
    """
    G = gram_f64(X, X)
    L = _chol_safe(G)
    R = L.conj().T
    return rsolve_f64(X, R), R


@jax.jit
def cholqr2_mp(X: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Two mixed-precision CholQR passes (see cholqr2)."""
    Q1, R1 = cholqr_mp(X)
    Q2, R2 = cholqr_mp(Q1)
    return Q2, mm(R2, R1)
