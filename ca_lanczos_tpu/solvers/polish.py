"""Final f64-operator Rayleigh–Ritz polish of a converged block.

A solve whose vectors AND operator are float32 is floored in accuracy:
the Rayleigh quotients inherit (a) f32 SpMV rounding and (b) the f32
REPRESENTATION error of the matrix itself —
|lambda(A_f32) - lambda(A_f64)| <= ||dA|| ~ eps_f32 * ||A||, i.e. a
~6e-8 relative floor that no amount of f32-side iteration can cross.

This pass runs AFTER the solve as its own device call(s): it takes the
f64 operator planes (the host has them — only the solve's streaming
copy is f32) and the locked block, and runs block-Krylov Rayleigh–Ritz
(residual expansion of depth `depth` per pass — a single residual block
contracts only ~(width-gap)/(width+gap) per RR pass against a wide
bulk; the depth-d Krylov applies the optimal degree-d polynomial
instead).

PRECISION SPLIT: the panel GEMMs — CGS projections, CholQR2, RR
assembly — run in f32 (at full f32 precision, ops.precision); float64
appears exactly where it buys accuracy:

* the SpMV against the TRUE f64 planes (cheap, bandwidth-bound);
* residual formation AQ - Q w in f64 before casting the DIRECTION to
  f32 (so the search direction is eps_f32-accurate relative to the
  residual, letting the subspace angle contract to the f32 storage
  floor instead of the eps_f32*||A||/gap residual floor);
* the final PER-VECTOR Rayleigh quotients and residuals, as f64
  elementwise dots (not GEMMs).  Rayleigh quotients are quadratic in
  the vector error, so f32-stored vectors at the ~1e-7 angle floor
  still give ~1e-12-grade values — the RR rotations only steer the
  subspace and need no f64.

Reference anchor: restarted_ca_lanczos.m:36-39 (tol = 1e-8 * normest);
BASELINE.md asks for 1e-10-grade Ritz parity at >=10M rows.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ca_lanczos_tpu.ops.precision import einsum, mm
from ca_lanczos_tpu.ops.spmv import DiaMatrix, spmv

# Per-(rows, L) f64 temporary budget for the chunk-fused passes.  A
# divisor-based chunking keeps L at ~2M rows regardless of panel height,
# so a tall stacked panel (mk = 40 rows in the final generalized Gram
# pair) would plan f64 temporaries of several GB at 11M rows.
# Bytes-budgeted chunks with tail padding (zero columns contribute
# nothing to applies, Grams or residual norms) keep every f64 temporary
# ~<=48 MB at any n.
_F64_CHUNK_BYTES = 48 << 20


def _chunks_for(n: int, rows: int):
    """(c, L, n_pad): column-chunking for f64 temporaries of ``rows``
    panel rows — L sized to the byte budget (1024-multiple), c*L =
    n_pad >= n; callers zero-pad columns [n, n_pad)."""
    L = _F64_CHUNK_BYTES // (max(rows, 1) * 8)
    L = max(1 << 15, min(1 << 21, (L // 1024) * 1024))
    if n <= L:
        return None
    c = -(-n // L)
    return c, L, c * L


def _spmv64_rm(A, Z):
    """A @ rows(Z): row-major (k, n) panel through the f64 operator.
    DIA: chunked along the row axis with bandwidth halos (one small f64
    chunk live); other operators: one row at a time through matvec."""
    from ca_lanczos_tpu.ops.qr import _mp_chunk_shape

    k, n = Z.shape
    if isinstance(A, DiaMatrix):
        ck = _mp_chunk_shape(n)
        offsets = A.offsets
        w = max((abs(o) for o in offsets), default=0)
        if ck is None:
            Z64 = Z.astype(jnp.float64)
            Zp = jnp.pad(Z64, ((0, 0), (w, w)))
            y = jnp.zeros((k, n), jnp.float64)
            for j, o in enumerate(offsets):
                y = y + A.data[j][None, :] * lax.dynamic_slice(
                    Zp, (0, w + o), (k, n))
            return y
        c, L = ck
        Zp = jnp.pad(Z, ((0, 0), (w, w)))
        Dp = jnp.pad(A.data, ((0, 0), (w, w)))

        def body(i, out):
            lo = i * L
            zc = lax.dynamic_slice(Zp, (0, lo), (k, L + 2 * w)).astype(jnp.float64)
            dc = lax.dynamic_slice(Dp, (0, lo), (A.data.shape[0], L + 2 * w))
            y = jnp.zeros((k, L), jnp.float64)
            for j, o in enumerate(offsets):
                y = y + dc[j, w : w + L][None, :] * lax.dynamic_slice(
                    zc, (0, w + o), (k, L))
            return lax.dynamic_update_slice(out, y, (0, lo))

        return lax.fori_loop(0, c, body, jnp.zeros((k, n), jnp.float64))

    def row(j, out):
        zj = lax.dynamic_slice(Z, (j, 0), (1, n))[0]
        yj = spmv(A, zj.astype(jnp.float64))
        return lax.dynamic_update_slice(out, yj[None, :], (j, 0))

    return lax.fori_loop(0, k, row, jnp.zeros((k, n), jnp.float64))


def _spmv32_rm(A32, Z):
    """A32 @ rows(Z), all-f32 row-major.  DIA gets the direct shifted
    form; other operators go row-by-row through matvec (a blocked (n, k)
    matvec would materialize a lane-padded column-major panel)."""
    k, n = Z.shape
    if isinstance(A32, DiaMatrix):
        offsets = A32.offsets
        w = max((abs(o) for o in offsets), default=0)
        Zp = jnp.pad(Z, ((0, 0), (w, w)))
        y = jnp.zeros((k, n), jnp.float32)
        for j, o in enumerate(offsets):
            y = y + A32.data[j][None, :] * lax.dynamic_slice(
                Zp, (0, w + o), (k, n))
        return y

    def row(j, out):
        zj = lax.dynamic_slice(Z, (j, 0), (1, n))[0]
        return lax.dynamic_update_slice(out, spmv(A32, zj)[None, :], (j, 0))

    return lax.fori_loop(0, k, row, jnp.zeros((k, n), jnp.float32))


def _gram64_rm(X, Y):
    """X Y^T accumulated in f64, column-chunked scan over row-major
    (k, n) panels — one small f64 chunk pair live."""
    from ca_lanczos_tpu.ops.qr import _mp_chunk_shape

    ck = _mp_chunk_shape(X.shape[1])
    if ck is None:
        return mm(X.astype(jnp.float64), Y.astype(jnp.float64).T)
    c, L = ck
    Xr = X.reshape(X.shape[0], c, L)
    Yr = Y.reshape(Y.shape[0], c, L)

    def body(i, acc):
        xc = lax.dynamic_index_in_dim(Xr, i, axis=1, keepdims=False)
        yc = lax.dynamic_index_in_dim(Yr, i, axis=1, keepdims=False)
        return acc + mm(xc.astype(jnp.float64), yc.astype(jnp.float64).T)

    z = jnp.zeros((X.shape[0], Y.shape[0]), jnp.float64)
    return lax.fori_loop(0, c, body, z)


@jax.jit
def _cholqr2_rm(Z):
    from ca_lanczos_tpu.ops.qr import _chol_safe

    for _ in range(2):
        G = mm(Z, Z.T)
        L = _chol_safe(G)
        Z = jax.scipy.linalg.solve_triangular(L, Z, lower=True)
    return Z


@jax.jit
def _proj_rm(B, Sx):
    """One CGS projection B <- B - (B Sx^T) Sx (row-major panels)."""
    return B - mm(mm(B, Sx.T), Sx)


@jax.jit
def _unit_rows(B):
    return B / jnp.maximum(jnp.linalg.norm(B, axis=1), 1e-300)[:, None]


def _dia_chunk_apply64(A, Zp, Dp, lo, rows, L, w):
    """f64 banded apply on one column-chunk of a padded row-major panel:
    returns (rows, L) f64.  Zp: (rows, n + 2w) f32; Dp: padded planes."""
    zc = lax.dynamic_slice(Zp, (0, lo), (rows, L + 2 * w)).astype(jnp.float64)
    dc = lax.dynamic_slice(Dp, (0, lo), (Dp.shape[0], L + 2 * w))
    y = jnp.zeros((rows, L), jnp.float64)
    for j, o in enumerate(A.offsets):
        y = y + dc[j, w : w + L][None, :] * lax.dynamic_slice(
            zc, (0, w + o), (rows, L))
    return y, zc[:, w : w + L]


@jax.jit
def _rq64(A, Q):
    """Per-vector f64 Rayleigh quotients, residual norms, and the f32
    residual DIRECTION block — all from chunk-fused f64 applies.

    No (k, n) f64 panel is ever materialized: f64 exists only on
    (k, chunk) temporaries inside the scan, and the outputs are
    k-vectors plus an f32 panel."""
    k, n = Q.shape
    ck = _chunks_for(n, k)
    if not isinstance(A, DiaMatrix) or ck is None:
        AQ = _spmv64_rm(A, Q)
        Q64 = Q.astype(jnp.float64)
        num = einsum("in,in->i", Q64, AQ)
        w = num / einsum("in,in->i", Q64, Q64)
        R = AQ - w[:, None] * Q64
        return w, jnp.linalg.norm(R, axis=1), _unit_rows(
            R.astype(jnp.float32))
    c, L, n_pad = ck
    wband = max((abs(o) for o in A.offsets), default=0)
    # Tail-pad to c*L: zero data/vector columns contribute nothing to
    # the quotients, residual norms, or the residual block.
    Zp = jnp.pad(Q, ((0, 0), (wband, wband + n_pad - n)))
    Dp = jnp.pad(A.data, ((0, 0), (wband, wband + n_pad - n)))

    def acc_body(i, nd):
        num, den = nd
        y, zc = _dia_chunk_apply64(A, Zp, Dp, i * L, k, L, wband)
        num = num + einsum("in,in->i", zc, y)
        den = den + einsum("in,in->i", zc, zc)
        return num, den

    z = jnp.zeros((k,), jnp.float64)
    num, den = lax.fori_loop(0, c, acc_body, (z, z))
    w = num / den

    def res_body(i, state):
        rs, B = state
        y, zc = _dia_chunk_apply64(A, Zp, Dp, i * L, k, L, wband)
        r = y - w[:, None] * zc
        rs = rs + einsum("in,in->i", r, r)
        B = lax.dynamic_update_slice(B, r.astype(jnp.float32), (0, i * L))
        return rs, B

    rs, B = lax.fori_loop(
        0, c, res_body, (z, jnp.zeros((k, n_pad), jnp.float32)))
    return w, jnp.sqrt(rs), _unit_rows(B[:, :n])


@jax.jit
def _gram64_pair_chunked(A, *stages):
    """(G, M) = (Z A Z^T, Z Z^T) in f64 for the STACKED panel Z =
    rows(stages), chunk-fused without ever materializing the (mk, n)
    stack — f64 exists only on (mk, chunk) temporaries sized to
    _F64_CHUNK_BYTES, and per-stage pads avoid a concat+pad (two
    full-panel copies)."""
    k, n = stages[0].shape
    mk = len(stages) * k
    ck = _chunks_for(n, mk)
    wband = max((abs(o) for o in A.offsets), default=0)
    if ck is None:
        Zp = jnp.pad(jnp.concatenate(stages, axis=0),
                     ((0, 0), (wband, wband)))
        Dp = jnp.pad(A.data, ((0, 0), (wband, wband)))
        y, zc = _dia_chunk_apply64(A, Zp, Dp, 0, mk, n, wband)
        return mm(zc, y.T), mm(zc, zc.T)
    c, L, n_pad = ck
    pads = tuple(
        jnp.pad(S, ((0, 0), (wband, wband + n_pad - n))) for S in stages
    )
    Dp = jnp.pad(A.data, ((0, 0), (wband, wband + n_pad - n)))

    def body(i, GM):
        G, M = GM
        ys, zs = [], []
        for Sp in pads:
            y, zc = _dia_chunk_apply64(A, Sp, Dp, i * L, k, L, wband)
            ys.append(y)
            zs.append(zc)
        yc = jnp.concatenate(ys, axis=0)  # (mk, L) — small
        zc = jnp.concatenate(zs, axis=0)
        return G + mm(zc, yc.T), M + mm(zc, zc.T)

    z = jnp.zeros((mk, mk), jnp.float64)
    return lax.fori_loop(0, c, body, (z, z))


@jax.jit
def _spmv32_jit(A32, B):
    return _unit_rows(_spmv32_rm(A32, B))


@jax.jit
def _gram32_rm(X, ASj):
    return mm(X, ASj.T).astype(jnp.float64)


@jax.jit
def _spmv32_only(A32, B):
    return _spmv32_rm(A32, B)


@jax.jit
def _spmv64_jit(A, B):
    return _spmv64_rm(A, B)


@jax.jit
def _gram64_jit(X, Y):
    return _gram64_rm(X, Y)


@jax.jit
def _assemble_rm(Uki, Sx, Q):
    return Q + mm(Uki.T, Sx)


def _polish_pass(A, A32, X, k: int, depth: int, final: bool = False):
    """One block-Krylov RR pass, HOST-SEQUENCED: each phase is its own
    small jit call (state stays device-resident).  X: (k, n) ROW-MAJOR
    f32; returns (w (k,) f64 Rayleigh quotients, resid (k,) f64,
    Q (k, n)).

    Why not one jit: XLA can loop-re-roll the unrolled stage loops into
    stacked [n_ops, k, n] buffers (several GB at 11M rows) — host
    sequencing caps every program at a few panels.  Row-major (k, n)
    panels keep each vector contiguous.

    final=True: the RR rotation runs off f64 GENERALIZED Gram matrices
    (G = Z A Z^T, M = Z Z^T, solved via Cholesky of M).  The fast
    passes' f32 Gram carries ~sqrt(n)*eps_f32 accumulation error
    (~1e-4 at 4M rows) which re-injects that much subspace mixing per
    rotation — a non-monotone ~5e-9 relative eigenvalue floor; the f64
    generalized form removes it and cancels f32-level panel
    non-orthonormality to first order."""
    m = depth + 1
    f32 = jnp.float32

    Q = _cholqr2_rm(X.astype(f32))
    w, _, B = _rq64(A, Q)

    stages = [Q]
    for d in range(depth):
        for _pass in range(2):  # CGS2 against previous stages (f32)
            for Sx in stages:
                B = _proj_rm(B, Sx)
        B = _cholqr2_rm(_unit_rows(B))
        stages.append(B)
        if d < depth - 1:
            # Krylov expansion stages ride the f32 twin: only the FIRST
            # residual direction is cancellation-sensitive (f64 in _rq64).
            B = _spmv32_jit(A32, B)

    # RR over the joint basis: f32 Grams for fast passes, f64
    # generalized pair for the final pass (docstring).
    if final and isinstance(A, DiaMatrix):
        # Chunk-fused f64 Gram pair: accurate A-products (casting A S to
        # f32 would steer the rotation by ~1e-5 — exactly the noise this
        # pass removes) without any f64 panel.
        Gm, Mm = _gram64_pair_chunked(A, *stages)
        Gm, Mm = np.asarray(Gm), np.asarray(Mm)
        Mm = (Mm + Mm.T) / 2
        import scipy.linalg as sla

        wa, Ua = sla.eigh((Gm + Gm.T) / 2, Mm)
    elif final:
        G = [[None] * m for _ in range(m)]
        M = [[None] * m for _ in range(m)]
        for j in range(m):
            ASj = _spmv64_jit(A, stages[j])
            for i in range(m):
                G[i][j] = _gram64_jit(stages[i], ASj)
                M[i][j] = _gram64_jit(stages[i], stages[j])
            del ASj
        Gm = np.block([[np.asarray(g) for g in row_] for row_ in G])
        Mm = np.block([[np.asarray(g) for g in row_] for row_ in M])
        Mm = (Mm + Mm.T) / 2
        import scipy.linalg as sla

        wa, Ua = sla.eigh((Gm + Gm.T) / 2, Mm)
    else:
        G = [[None] * m for _ in range(m)]
        for j in range(m):
            ASj = _spmv32_only(A32, stages[j])
            for i in range(m):
                G[i][j] = _gram32_rm(stages[i], ASj)
            del ASj
        Gm = np.block([[np.asarray(g) for g in row_] for row_ in G])
        wa, Ua = np.linalg.eigh((Gm + Gm.T) / 2)
    order = np.argsort(wa)[::-1][:k]
    Uk = jnp.asarray(Ua[:, order], f32)
    Q = jnp.zeros_like(stages[0])
    for i in range(m):
        Q = _assemble_rm(Uk[i * k : (i + 1) * k], stages[i], Q)
    Q = _cholqr2_rm(Q)
    w, resid, _ = _rq64(A, Q)
    return np.asarray(w), np.asarray(resid), Q


def rayleigh_ritz_polish(
    A64, X, iters: int = 3, depth: int = 4
) -> Tuple[np.ndarray, np.ndarray, jax.Array]:
    """Polish a locked block against the f64 operator.

    A64: the operator with FLOAT64 data planes (e.g. a DiaMatrix built
    from the host's f64 arrays — not the solve's f32 streaming copy).
    X: (n, k) converged block, any float dtype, natural row order.
    iters x depth: outer RR passes x residual block-Krylov depth per
    pass; each pass is a short sequence of device calls with state
    device-resident in between.

    Returns (eigs desc (k,) f64, true absolute residuals ||Ax - wx||
    (k,) f64, polished orthonormal block (n, k) f32 device array).
    """
    if np.dtype(A64.dtype) != np.float64:
        raise ValueError(
            f"polish needs f64 operator planes, got {np.dtype(A64.dtype)}"
        )
    k = int(X.shape[1])
    # f32 twin for the non-cancellation-sensitive applies (Krylov
    # expansion stages, fast-pass Grams).
    A32 = jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64
        else x,
        A64,
    )
    # Internal state is ROW-MAJOR (k, n) — see _polish_pass docstring;
    # one transpose in, one out.
    Q = jnp.asarray(X).T
    w = resid = None
    total = max(int(iters), 1)
    for it in range(total):
        w, resid, Q = _polish_pass(
            A64, A32, Q, k, int(depth), final=(it == total - 1)
        )
        jax.block_until_ready(Q)
    return np.asarray(w), np.asarray(resid), Q.T


def rayleigh_ritz_polish_host(
    matvec, X, iters: int = 3, depth: int = 4
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-numpy f64 polish — the path for operators the device
    polish does not cover (general sparsity, permuted routes).

    matvec: callable (n, j) f64 -> (n, j) f64 applying the TRUE f64
    operator (e.g. a scipy.sparse matrix's __matmul__).
    X: (n, k) block (device array or numpy, any float dtype).
    Returns (w desc (k,) f64, true residuals (k,), Q (n, k) f64).
    """
    X = np.asarray(X, np.float64)
    n, k = X.shape
    m = depth + 1

    def orth(Z):
        # CholQR2: ~4x faster than Householder QR on tall panels and
        # orthonormal to roundoff in f64 for the conditioning here.
        for _ in range(2):
            G = Z.T @ Z
            import scipy.linalg as sla

            L = np.linalg.cholesky(G + np.trace(G) * 1e-15 * np.eye(len(G)))
            Z = sla.solve_triangular(L, Z.T, lower=True).T
        return Z

    def unit(Z):
        return Z / np.maximum(np.linalg.norm(Z, axis=0), 1e-300)[None, :]

    Q = orth(X)
    AQ = matvec(Q)
    w = np.einsum("ij,ij->j", Q, AQ)

    for it in range(max(int(iters), 1)):
        stages = [Q]
        B = unit(AQ - Q * w[None, :])
        for d in range(depth):
            for _ in range(2):
                for Sx in stages:
                    B = B - Sx @ (Sx.T @ B)
            B = orth(unit(B))
            stages.append(B)
            if d < depth - 1:
                B = unit(matvec(B))
        Z = np.concatenate(stages, axis=1)  # (n, mk), orthonormal-ish
        AZ = matvec(Z)
        G = Z.T @ AZ
        M = Z.T @ Z
        import scipy.linalg as sla

        wa, Ua = sla.eigh((G + G.T) / 2, (M + M.T) / 2)
        order = np.argsort(wa)[::-1][:k]
        Q = orth(Z @ Ua[:, order])
        AQ = matvec(Q)
        w = np.einsum("ij,ij->j", Q, AQ)
    resid = np.linalg.norm(AQ - Q * w[None, :], axis=0)
    return w, resid, Q
