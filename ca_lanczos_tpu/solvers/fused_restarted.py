"""Fully-on-device restarted CA-Lanczos: the whole solve in ONE XLA call.

The host drivers (solvers.restarted) keep the restart state machine in
Python — per block they synchronize R factors, per cycle they eig the
small T, and every synchronization leaves the device idle.  This driver
moves EVERYTHING under one jit:

* CA blocks with two-pass CGS + shifted CholQR2 (the throughput orth),
  the Tk-from-R-factors recurrence (ca_lanczos.m:200-223) done in jnp
  small math;
* eigh of the cycle T on device;
* candidate verification by a single multivector SpMV (true residuals —
  the same catastrophic-lie guard as the host driver);
* fixed-shape Ritz locking: Qconv is padded to 2*n_wanted columns and
  candidates merge in via masked dynamic_update_slice, so no shape ever
  depends on the lock count;
* the cycle loop is a lax.while_loop on (nconv < n_wanted) & (cycle <
  max_restarts).

Semantics match dist_restarted_ca_lanczos with orth=LOCAL (always-2-pass
CGS; passing candidates locked in descending order with true-residual
verification).  Adaptive per-cycle diagnostics live on the host drivers.

Precision: float64 converges to reference accuracy (2e-13 in 3 cycles on
the gapped test spectrum); float32 locks eigenpairs down to its
verification floor and then honestly stops locking (partial nconv) —
use f64 for full eigenvector convergence, f32 for eigenvalue estimates.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ca_lanczos_tpu.config import Basis
from ca_lanczos_tpu.ops.matrix_powers import _newton_scan
from ca_lanczos_tpu.ops.precision import einsum, mm
from ca_lanczos_tpu.ops.qr import cholqr2, cholqr2_mp
from ca_lanczos_tpu.ops.spmv import Operator, normest, spmv
from ca_lanczos_tpu.solvers.ca_lanczos import build_basis_matrix, monomial_basis_matrix


def _rdiv(X, Y):
    """X @ inv(Y) for an UPPER-TRIANGULAR Y (every caller passes an R
    factor): one triangular solve instead of a general LU solve."""
    return jax.scipy.linalg.solve_triangular(Y.T, X.T, lower=True).T


def _block_T_jnp(Rkk_s, Rk_s, Bk, b_prev, s):
    """Device mirror of solvers._block.block_T (ca_lanczos.m:200-214)."""
    Rkk = jnp.concatenate([jnp.zeros((s, 1), Rkk_s.dtype), Rkk_s[:s, :]], axis=1)
    Rk = jnp.zeros((s + 1, s + 1), Rk_s.dtype)
    Rk = Rk.at[0, 0].set(1.0)
    Rk = Rk.at[0, 1:].set(Rkk_s[s, :s])
    Rk = Rk.at[1:, 1:].set(Rk_s)
    zk = Rk[:s, s]
    rho = Rk[s, s]
    rho_t = Rk[s - 1, s - 1]
    bk = Bk[s, s - 1]
    Rs = Rk[:s, :s]
    es = jnp.zeros(s, Rk.dtype).at[s - 1].set(1.0)
    e1 = jnp.zeros(s, Rk.dtype).at[0].set(1.0)
    main = _rdiv(mm(Rs, Bk[:s, :]), Rs)
    corr = (bk / rho_t) * jnp.outer(zk, es)
    last_row = _rdiv(Rkk[:s, :s][s - 1 : s, :], Rs)
    Tk = main + corr - b_prev * jnp.outer(e1, last_row[0])
    beta_k = bk * (rho / rho_t)
    return Tk, beta_k


@dataclasses.dataclass
class FusedRestartedResult:
    eigs: np.ndarray  # (n_wanted,) locked eigenvalues (NaN where unlocked)
    Q_conv: jax.Array  # (n, n_wanted)
    nconv: int
    n_restarts: int
    converged: bool


def _make_cycle_body(
    A: Operator,
    Bk: jax.Array,  # (s+1, s)
    tol: jax.Array,
    lam_bound: jax.Array,
    s: int,
    iters: int,
    n_wanted: int,
    mixed_precision: bool,
):
    """Build the one-restart-cycle transition on state
    (q, Qconv, eigs_acc, nconv, cycle) — shared by the single-call
    while_loop and the bounded-burst driver."""
    # mixed_precision (OrthParams.mixed_precision semantics, on device):
    # basis/SpMV/Q storage stay in `dtype` (f32), the small reductions —
    # Gram products, Cholesky, R factors, T recovery, eigh, residual
    # norms — run float64.  The f32 Gram is the eigenvalue error floor
    # the plain-f32 flagship hits (~2^-24 relative); promoting the
    # O(n m^2) reductions fixes it at small cost next to the SpMV stream.
    m = s * iters
    qr2 = cholqr2_mp if mixed_precision else cholqr2

    def proj(Q, X):
        """One CGS pass X <- X - Q (Q^T X); f64 under mixed precision
        (mirror of ops.orth._proj_block_mp).  The f64 products run
        row-chunked (ops.qr.gram_f64/sub_proj_f64) so no promoted copy
        of the (n, m) basis is ever resident — required at the 10M-row
        scale."""
        if mixed_precision:
            from ca_lanczos_tpu.ops.qr import gram_f64, sub_proj_f64

            R = gram_f64(Q, X)
            return sub_proj_f64(X, Q, R), R
        R = mm(Q.T, X)
        return X - mm(Q, R), R

    def cycle_body(state):
        q, Qconv, eigs_acc, nconv, cycle = state
        n = q.shape[0]
        dtype = q.dtype
        ctype = jnp.float64 if mixed_precision else dtype

        # ---- inner CA blocks -------------------------------------------
        Tmat = jnp.zeros((m, m), ctype)
        betas = jnp.zeros(iters, ctype)
        Q_cycle = jnp.zeros((n, m), dtype)

        # powers through the generic recurrence driven by Bk columns
        diag = jnp.diagonal(Bk)[:s].astype(dtype)
        sup = jnp.zeros(s, dtype)
        if s > 1:
            sup = sup.at[1:].set(jnp.diagonal(Bk, 1)[: s - 1].astype(dtype))

        def powers(qv):
            return _newton_scan(A, qv, s, diag, sup)  # (n, s+1)

        # first block
        Vb = powers(q)
        Qb, Rk = qr2(Vb)
        # lock against Qconv (zero columns are no-ops), then re-normalize
        for _ in range(2):
            Qb, _ = proj(Qconv, Qb)
        Qb, _ = qr2(Qb)
        T1 = _rdiv(mm(Rk, Bk), Rk[:s, :s])
        Tmat = Tmat.at[:s, :s].set(T1[:s, :s])
        betas = betas.at[0].set(T1[s, s - 1])
        c0 = min(s + 1, m)
        Q_cycle = Q_cycle.at[:, :c0].set(Qb[:, :c0])
        Q_prev = Qb

        for k in range(2, iters + 1):
            Vb = powers(Q_prev[:, -1])
            X = Vb[:, 1:]
            Rkk = jnp.zeros((s + 1, s), ctype)
            for _ in range(2):
                X, Rp = proj(Q_prev, X)
                Rkk = Rkk + Rp
            X, _ = proj(Qconv, X)
            Q_new, Rn = qr2(X)
            Tk, b_k = _block_T_jnp(Rkk, Rn, Bk, betas[k - 2], s)
            lo = (k - 1) * s
            Tmat = Tmat.at[lo : lo + s, lo : lo + s].set(Tk)
            Tmat = Tmat.at[lo, lo - 1].set(betas[k - 2])
            Tmat = Tmat.at[lo - 1, lo].set(betas[k - 2])
            betas = betas.at[k - 1].set(b_k)
            hi = min(lo + s + 1, m)
            Q_cycle = Q_cycle.at[:, lo + 1 : hi].set(Q_new[:, : hi - lo - 1])
            Q_prev = jnp.concatenate([Q_prev[:, -1:], Q_new], axis=1)

        # ---- Ritz extraction + verification ----------------------------
        Tsym = (Tmat + Tmat.T) / 2
        d, Vp = jnp.linalg.eigh(Tsym)  # ascending
        beta_m = betas[iters - 1]
        rn = beta_m * jnp.abs(Vp[m - 1, :])

        order = jnp.argsort(d)[::-1][:n_wanted]
        d_top = d[order]
        rn_top = rn[order]
        X_top = mm(Q_cycle, Vp[:, order].astype(dtype))  # (n, n_wanted)

        # true residuals (multivector SpMV) — catastrophic-lie guard;
        # the norm reduction accumulates in ctype (f64 under mp).
        R_true = spmv(A, X_top) - X_top * d_top.astype(dtype)[None, :]
        true_abs = jnp.sqrt(
            einsum("ij,ij->j", R_true, R_true, preferred_element_type=ctype)
        )

        # Estimate-consistency verification (solvers.restarted._verify_gate
        # rationale): reject locks whose true residual exceeds the
        # estimate by >1e3x, floored by the basis dtype's legitimate
        # drift (f32 basis storage at the >=4M-row scale measures true
        # lock residuals ~1.2e-4*||A|| with at-the-gate estimates; a
        # tighter floor deadlocks the flagship rejecting honest pairs —
        # the f64 polish sets final accuracy afterwards).
        floor = 1e-3 if dtype == jnp.float32 else 1e-4
        gate = jnp.maximum(1e3 * rn_top, floor * lam_bound)
        passed = (rn_top < tol) & (true_abs < gate) & (jnp.abs(d_top) <= 1.05 * lam_bound)
        # Compact ANY passing candidates to the front (stable: descending
        # eigenvalue order preserved within the passing group) — a prefix
        # rule would deadlock whenever the top candidate persistently
        # fails verification.
        perm = jnp.argsort(jnp.logical_not(passed), stable=True)
        d_p = d_top[perm]
        X_p = X_top[:, perm]
        npass = jnp.sum(passed.astype(jnp.int32)).astype(jnp.int32)
        avail = jnp.asarray(n_wanted, jnp.int32) - nconv
        k_new = jnp.minimum(npass, avail)
        lock = jnp.arange(n_wanted) < k_new

        # merge candidates into Qconv / eigs at column offset nconv
        zero_i = jnp.asarray(0, nconv.dtype)
        old_q = lax.dynamic_slice(Qconv, (zero_i, nconv), (n, n_wanted))
        upd_q = jnp.where(lock[None, :], X_p, old_q)
        Qconv = lax.dynamic_update_slice(Qconv, upd_q, (zero_i, nconv))
        old_e = lax.dynamic_slice(eigs_acc, (nconv,), (n_wanted,))
        upd_e = jnp.where(lock, d_p, old_e)
        eigs_acc = lax.dynamic_update_slice(eigs_acc, upd_e, (nconv,))
        nconv = (nconv + k_new).astype(jnp.int32)

        # restart vector: the largest candidate that did not lock
        idx = jnp.minimum(npass, n_wanted - 1).astype(jnp.int32)
        q_next = lax.dynamic_slice(X_p, (zero_i, idx), (n, 1))[:, 0]
        q_next = q_next / jnp.linalg.norm(q_next)

        return (q_next, Qconv, eigs_acc, nconv, cycle + 1)

    return cycle_body


def _make_refine(A, n_wanted: int, mixed_precision: bool):
    """Final refinement of the locked block: pairs lock off the
    loose estimate+catastrophic-lie guard (host verify_locked
    semantics), so a locked value's error is set by its true residual
    at lock time.  A Rayleigh–Ritz pass on the converged subspace
    replaces each value with the subspace Rayleigh quotient
    (residual^2-level error, f64 Gram under mixed precision), and two
    residual-augmented RR iterations (RR on [X, AX - XΛ] — the
    LOBPCG expansion without the P block) drive the subspace residual
    toward the storage-dtype floor first."""
    qr2 = cholqr2_mp if mixed_precision else cholqr2

    def refine(args):
        Qc, _ = args
        dtype = Qc.dtype
        ctype = jnp.float64 if mixed_precision else dtype
        k = n_wanted

        def gram(Za, Zb):
            if mixed_precision:
                from ca_lanczos_tpu.ops.qr import gram_f64

                return gram_f64(Za, Zb)
            return mm(Za.T, Zb)

        def rr_top(Z, AZ):
            G = gram(Z, AZ)
            w, U = jnp.linalg.eigh((G + G.T) / 2)  # ascending
            order = jnp.argsort(w)[::-1][:k]
            Uk = U[:, order].astype(dtype)
            return mm(Z, Uk), mm(AZ, Uk), w[order]

        Qb, _ = qr2(Qc)
        Qb, AQ, w = rr_top(Qb, spmv(A, Qb))
        for _ in range(2):
            Rres = AQ - Qb * w.astype(dtype)[None, :]
            Z = jnp.concatenate([Qb, Rres], axis=1)
            Z, _ = qr2(Z)
            Qb, AQ, w = rr_top(Z, spmv(A, Z))
        return Qb, w.astype(ctype)

    return refine


_CYCLE_STATICS = ("s", "iters", "n_wanted", "mixed_precision")


@partial(jax.jit, static_argnames=_CYCLE_STATICS + ("max_restarts",))
def _fused_restarted(
    A: Operator,
    q0: jax.Array,
    Bk: jax.Array,
    tol: jax.Array,
    lam_bound: jax.Array,
    s: int,
    iters: int,
    n_wanted: int,
    max_restarts: int,
    mixed_precision: bool = False,
):
    """The whole solve in ONE device call (module docstring)."""
    n = q0.shape[0]
    dtype = q0.dtype
    ctype = jnp.float64 if mixed_precision else dtype
    cycle_body = _make_cycle_body(
        A, Bk, tol, lam_bound, s, iters, n_wanted, mixed_precision,
    )

    def cond(state):
        _, _, _, nconv, cycle = state
        return (nconv < n_wanted) & (cycle < max_restarts)

    Qconv0 = jnp.zeros((n, 2 * n_wanted), dtype)
    eigs0 = jnp.full((2 * n_wanted,), jnp.nan, ctype)
    state = (q0, Qconv0, eigs0, jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    q, Qconv, eigs_acc, nconv, cycles = lax.while_loop(cond, cycle_body, state)

    refine = _make_refine(A, n_wanted, mixed_precision)
    Qc_w = Qconv[:, :n_wanted]
    ei_w = eigs_acc[:n_wanted]
    Qc_w, ei_w = lax.cond(
        nconv >= n_wanted, refine, lambda a: a, (Qc_w, ei_w)
    )
    return Qc_w, ei_w, nconv, cycles


@partial(jax.jit, static_argnames=_CYCLE_STATICS + ("max_restarts", "burst"))
def _fused_burst(
    A: Operator,
    q: jax.Array,
    Qconv: jax.Array,  # (n, 2*n_wanted) carried across calls
    eigs_acc: jax.Array,  # (2*n_wanted,) ctype
    nconv: jax.Array,  # int32 scalar
    cycle: jax.Array,  # int32 scalar, GLOBAL cycle count
    Bk: jax.Array,
    tol: jax.Array,
    lam_bound: jax.Array,
    s: int,
    iters: int,
    n_wanted: int,
    max_restarts: int,
    burst: int,
    mixed_precision: bool = False,
):
    """Up to `burst` restart cycles in one device call.

    Bounded variant of `_fused_restarted`: the host loops over bursts
    (a checkpoint/progress boundary).  The full state is carried as
    device arrays between calls — the (n, 2k) Qconv block never leaves
    the device, only the nconv/cycle scalars are read back per burst.
    One compiled program serves every burst (the local counter resets
    to 0 each call)."""
    cycle_body = _make_cycle_body(
        A, Bk, tol, lam_bound, s, iters, n_wanted, mixed_precision,
    )

    def body(state):
        inner, local = state
        return cycle_body(inner), local + 1

    def cond(state):
        (_, _, _, nconv_, cycle_), local = state
        return (
            (nconv_ < n_wanted)
            & (cycle_ < max_restarts)
            & (local < burst)
        )

    state = ((q, Qconv, eigs_acc, nconv, cycle), jnp.asarray(0, jnp.int32))
    (q, Qconv, eigs_acc, nconv, cycle), _ = lax.while_loop(cond, body, state)
    return q, Qconv, eigs_acc, nconv, cycle


@partial(jax.jit, static_argnames=("n_wanted", "mixed_precision"))
def _fused_refine(A, Qc, ei, n_wanted: int, mixed_precision: bool = False):
    return _make_refine(A, n_wanted, mixed_precision)((Qc, ei))


def fused_restarted_ca_lanczos(
    A: Operator,
    r,
    max_lanczos: int,
    n_wanted: int = 10,
    s: int = 8,
    basis: Basis = Basis.NEWTON,
    tol: float = 1.0e-8,
    max_restarts: int = 200,
    mixed_precision: bool = False,
    cycles_per_call: Optional[int] = None,
    on_burst=None,
) -> FusedRestartedResult:
    """One-XLA-call restarted CA-Lanczos (see module docstring).

    The Newton bootstrap (2s-step standard Lanczos + Leja ordering,
    restarted_ca_lanczos.m:61-71) stays on the host — it runs once.

    mixed_precision: f32 basis/SpMV storage with f64 Gram/R/T/eigh
    reductions on device (requires jax_enable_x64): reference accuracy
    at f32 bandwidth in one XLA call.

    cycles_per_call: if set, run at most this many restart cycles per
    device call and loop on the host (state stays device-resident; only
    the nconv/cycle scalars are read back per burst).  Numerics are
    identical to the single-call path — the cycle transition is the
    same compiled function.  Use it as a checkpoint/progress boundary:
    `on_burst(cycle, nconv)` fires after each burst if given.
    """
    basis = Basis(basis)
    norm_A = normest(A)
    r = jnp.asarray(r)
    q0 = r / jnp.linalg.norm(r)
    if basis == Basis.MONOMIAL:
        Bk = monomial_basis_matrix(s)
    else:
        Bk = build_basis_matrix(A, q0, s, basis)
    iters = max_lanczos // s
    if iters == 0:
        raise ValueError(f"max_lanczos={max_lanczos} < s={s}")

    Bk_np = np.asarray(Bk, np.float64)
    ctype = jnp.float64 if mixed_precision else q0.dtype
    statics = dict(mixed_precision=mixed_precision)
    operands = (
        jnp.asarray(Bk_np, ctype),
        jnp.asarray(tol * norm_A, ctype),
        jnp.asarray(norm_A, ctype),
        s,
        iters,
        n_wanted,
        max_restarts,
    )
    if cycles_per_call is None:
        Qc, eigs, nconv, cycles = _fused_restarted(A, q0, *operands, **statics)
    else:
        n = q0.shape[0]
        q = q0
        Qconv = jnp.zeros((n, 2 * n_wanted), q0.dtype)
        eigs_acc = jnp.full((2 * n_wanted,), jnp.nan, ctype)
        nconv = jnp.asarray(0, jnp.int32)
        cycles = jnp.asarray(0, jnp.int32)
        while True:
            q, Qconv, eigs_acc, nconv, cycles = _fused_burst(
                A, q, Qconv, eigs_acc, nconv, cycles, *operands,
                burst=int(cycles_per_call), **statics,
            )
            nconv_h, cycles_h = int(nconv), int(cycles)
            if on_burst is not None:
                on_burst(cycles_h, nconv_h)
            if nconv_h >= n_wanted or cycles_h >= max_restarts:
                break
        Qc = Qconv[:, :n_wanted]
        eigs = eigs_acc[:n_wanted]
        if nconv_h >= n_wanted:
            Qc, eigs = _fused_refine(
                A, Qc, eigs, n_wanted, mixed_precision=mixed_precision
            )
    nconv = int(nconv)
    return FusedRestartedResult(
        eigs=np.asarray(eigs),
        Q_conv=Qc,
        nconv=nconv,
        n_restarts=int(cycles),
        converged=nconv >= n_wanted,
    )
