"""Distributed explicitly-restarted CA-Lanczos over a ('rows',) mesh.

The flagship driver (restarted_ca_lanczos.m) with all large-array state
row-sharded: the inner CA blocks run as ONE jitted mesh step each
(halo-exchange matrix powers + psum block CGS against the previous block
AND the locked converged basis + slot-psum TSQR), Ritz locking and
restart control remain O((st)^2) host math.

Twist vs the host driver: the locked basis ``Q_conv`` is kept
at a FIXED padded width (2*n_wanted columns — headroom for wrong-end
deflation locks, zero-filled beyond nconv) so the jitted step compiles
once and is reused across all restarts — projecting against zero columns
is a natural no-op (their Gram rows are zero), so no masking or
recompilation is needed as eigenpairs lock.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec

from ca_lanczos_tpu.config import Basis, LanczosConfig, RestartStrategy
from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.ops.spmv import normest
from ca_lanczos_tpu.parallel.dist_ell import dist_ell_matrix_powers
from ca_lanczos_tpu.parallel.dist_orth import local_project, local_qr
from ca_lanczos_tpu.parallel.distributed import DistDia, dist_spmv
from ca_lanczos_tpu.parallel.mesh import row_axes, row_spec
from ca_lanczos_tpu.parallel.step import _local_powers_fn, newton_coeffs
from ca_lanczos_tpu.solvers._block import block_T, extend_T, first_block_T
from ca_lanczos_tpu.solvers.ca_lanczos import build_basis_matrix, monomial_basis_matrix
from ca_lanczos_tpu.solvers.restarted import (
    RestartedResult, _finalize, _lock_converged, _verify_floor,
    _verify_gate, _wanted_converged,
)


def _dist_spmv_any(Adist, x, mesh):
    """One distributed SpMV for DistDia / DistEll / DistBsr shards."""
    if isinstance(Adist, DistDia):
        return dist_spmv(Adist, x, mesh)
    z = jnp.zeros(1, x.dtype)
    from ca_lanczos_tpu.parallel.dist_bsr import DistBsr, dist_bsr_matrix_powers

    if isinstance(Adist, DistBsr):
        return dist_bsr_matrix_powers(Adist, x, 1, z, z, mesh)[:, 1]
    return dist_ell_matrix_powers(Adist, x, 1, z, z, mesh)[:, 1]


# Lockless cycles tolerated before a random restart (stagnation guard).
_STALL_CYCLES = 5


@partial(jax.jit, static_argnames=("s", "mesh", "qr_method", "safe", "mp"))
def _dist_first_block_locked(
    A, q, Qconv, diag, sub, s: int, mesh: Mesh, qr_method: str = "tsqr",
    safe: bool = False, key=None, mp: bool = False,
):
    """First CA block of a restart cycle: powers -> TSQR -> lock against
    Q_conv (restarted_ca_lanczos.m:311-319).  A: a distributed operator.

    ``safe=True`` routes the normalization through local_qr_safe, the
    masked in-jit null-space randomization (normalize.m:28-51), so a
    rank-deficient powers block (e.g. a start vector on an invariant
    subspace) cannot poison the basis."""
    from ca_lanczos_tpu.parallel.dist_orth import local_qr_safe

    axes = row_axes(mesh)
    powers, operands = _local_powers_fn(A, s, axes)
    if key is None:
        key = jax.random.PRNGKey(0)

    def body(*args):
        *op_blocks, x_local, Qc_local, dg, sb, k = args
        V = powers(*op_blocks, x_local, dg, sb)
        if safe:
            Qb, R, rank = local_qr_safe(V, qr_method, key=k, mp=mp, axes=axes)
        else:
            Qb, R = local_qr(V, qr_method, mp, axes)
            rank = jnp.asarray(V.shape[1])
        Qb, _ = local_project(Qc_local, Qb, passes=2, mp=mp, axes=axes)
        # Renormalize after the projection pass (projectAndNormalize).
        Qb, _ = local_qr(Qb, qr_method, mp, axes)
        return Qb, R, rank

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple([row_spec(mesh)] * (len(operands) + 2))
        + (PartitionSpec(), PartitionSpec(), PartitionSpec()),
        out_specs=(row_spec(mesh), PartitionSpec(), PartitionSpec()),
    )(*operands, q, Qconv, diag, sub, key)


@partial(jax.jit, static_argnames=("s", "mesh", "qr_method", "safe", "mp"))
def _dist_ca_block_locked(
    A, Q_prev, Qconv, diag, sub, s: int, mesh: Mesh, qr_method: str = "tsqr",
    safe: bool = False, key=None, mp: bool = False,
):
    """CA block k>1 with locking: project the new block against the
    previous s+1 columns AND the padded converged basis
    (restarted_ca_lanczos.m:324).  A: a distributed operator."""
    from ca_lanczos_tpu.parallel.dist_orth import local_qr_safe

    axes = row_axes(mesh)
    powers, operands = _local_powers_fn(A, s, axes)
    if key is None:
        key = jax.random.PRNGKey(0)

    def body(*args):
        *op_blocks, Qp_local, Qc_local, dg, sb, k = args
        q_local = Qp_local[:, -1]
        V = powers(*op_blocks, q_local, dg, sb)
        X = V[:, 1:]
        Y, Rkk = local_project(Qp_local, X, passes=2, mp=mp, axes=axes)
        Y, _ = local_project(Qc_local, Y, passes=1, mp=mp, axes=axes)
        if safe:
            Q_new, R, _ = local_qr_safe(Y, qr_method, key=k, mp=mp, axes=axes)
        else:
            Q_new, R = local_qr(Y, qr_method, mp, axes)
        return Q_new, Rkk, R

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple([row_spec(mesh)] * (len(operands) + 2))
        + (PartitionSpec(), PartitionSpec(), PartitionSpec()),
        out_specs=(row_spec(mesh), PartitionSpec(), PartitionSpec()),
    )(*operands, Q_prev, Qconv, diag, sub, key)


@partial(jax.jit, static_argnames=("mesh", "qr_method", "mp"))
def _dist_reorth(Qhist, X, mesh: Mesh, qr_method: str = "tsqr",
                 mp: bool = False):
    """Re-orthogonalize X against the zero-padded cycle history (two CGS
    passes + renormalize) — the device step behind the distributed FULL
    and PERIODIC modes.  Unwritten (zero) history columns project as
    no-ops, so the step keeps one static shape for the whole cycle.

    Mirrors the reference's extra projectAndNormalize whose R factors are
    discarded (restarted_ca_lanczos.m:333, :544): T keeps the first-pass
    factors; the cleanup only restores orthogonality.
    """

    axes = row_axes(mesh)

    def body(Qh_local, X_local):
        Y, _ = local_project(Qh_local, X_local, passes=2, mp=mp, axes=axes)
        Q, _ = local_qr(Y, qr_method, mp, axes)
        return Q

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(row_spec(mesh), row_spec(mesh)),
        out_specs=row_spec(mesh),
    )(Qhist, X)


@partial(jax.jit, static_argnames=("mesh",))
def _dist_ritz_vector(Q_blocks, w, mesh: Mesh):
    """x = [blocks] @ w on the mesh (row-sharded GEMV)."""

    def body(Qb_local, w_rep):
        return mm(Qb_local, w_rep)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(row_spec(mesh), PartitionSpec()),
        out_specs=row_spec(mesh),
    )(Q_blocks, w)


@jax.jit
def _deflate_start(q, Qconv):
    """Two CGS passes of the start vector against the (padded) locked
    basis + renormalize; zero columns are no-ops.  GSPMD handles the
    sharded contraction."""
    for _ in range(2):
        q = q - mm(Qconv, mm(Qconv.T, q))
    return q / jnp.linalg.norm(q)


def dist_restarted_ca_lanczos(
    A,
    r,
    max_lanczos: int,
    mesh: Mesh,
    config: LanczosConfig = LanczosConfig(),
    checkpoint_path=None,
    resume_from=None,
    safe_qr: bool = False,
) -> RestartedResult:
    """Row-sharded restarted CA-Lanczos (flagship, multi-chip).

    Matches solvers.restarted.restarted_ca_lanczos, with the block CGS
    always two passes (parallel.dist_orth).  Orth modes:
    LOCAL (default); FULL (every block re-orthogonalized against the
    zero-padded cycle history — one static-shape jitted step); PERIODIC
    (host omega recurrence triggers the same history reorth,
    restarted_ca_lanczos.m:531-546); SELECTIVE (converged Ritz vectors
    tracked in a fixed-width padded basis that rides along with Q_conv in
    the block projection, restarted_ca_lanczos.m:436-454).  The basis of
    each cycle lives as a (n_pad, s*iters) sharded array assembled from
    the per-block step outputs.

    checkpoint_path: serialize the restart-boundary state (gathered
    Q_conv, conv eigs, next start vector, Bk, rng) after every restart
    (utils.checkpoint.RestartCheckpoint); resume_from continues a run
    from such a file, re-sharding the state over ``mesh``.  safe_qr
    routes block normalizations through the masked in-jit null-space
    randomization (parallel.dist_orth.local_qr_safe).
    """
    from ca_lanczos_tpu.config import Orth
    from ca_lanczos_tpu.utils.diagnostics import OmegaRecurrence

    s = config.s
    basis = Basis(config.basis)
    orth = Orth(config.orth)
    norm_A = normest(A)
    tol = config.tol * norm_A
    rng = np.random.default_rng(config.seed)

    r_np = np.asarray(r, np.float64)
    q_host = r_np / np.linalg.norm(r_np)
    if basis == Basis.MONOMIAL:
        Bk = monomial_basis_matrix(s)
    else:
        Bk = build_basis_matrix(A, jnp.asarray(q_host), s, basis)
    diag_np, sub_np = newton_coeffs(Bk)

    from ca_lanczos_tpu.parallel.step import partition_operator

    Adist = partition_operator(A, mesh, s_max=s)
    n = A.n
    q = Adist.shard_vector(q_host, mesh)
    dtype = q.dtype
    diag = jnp.asarray(diag_np, dtype)
    sub = jnp.asarray(sub_np, dtype)

    iters = max_lanczos // s
    if iters == 0:
        raise ValueError(f"max_lanczos={max_lanczos} < s={s}")
    m = s * iters

    hist_dtype = np.float64
    # Fixed-width padded locked basis (see module doc).  2x headroom:
    # Lanczos converges both spectrum ends, and wrong-end pairs are
    # still locked for deflation while only pairs dominating every
    # unconverged estimate count as WANTED (_wanted_converged).
    lock_cap = 2 * config.n_wanted
    Qconv = Adist.state_zeros(lock_cap, mesh, hist_dtype)

    conv_eigs: List[float] = []
    conv_rnorms: List[float] = []
    orth_err: List[float] = []
    rnorm_rows: List[np.ndarray] = []
    nconv = 0
    n_restarts = 0
    restart = True
    stall = 0  # consecutive lockless cycles (see stagnation note below)

    if resume_from is not None:
        from ca_lanczos_tpu.utils.checkpoint import RestartCheckpoint

        ck = RestartCheckpoint.load(resume_from)
        n_restarts = ck.n_restarts
        nconv = ck.nconv
        conv_eigs = list(ck.conv_eigs)
        conv_rnorms = list(ck.conv_rnorms)
        orth_err = list(ck.orth_err)
        rnorm_rows = list(ck.rnorm_rows)
        Bk = ck.Bk
        diag_np, sub_np = newton_coeffs(Bk)
        diag = jnp.asarray(diag_np, dtype)
        sub = jnp.asarray(sub_np, dtype)
        if ck.Q_conv is not None:
            qc = np.zeros((n, config.n_wanted))
            qc[:, : ck.Q_conv.shape[1]] = ck.Q_conv
            Qconv = Adist.shard_vector(qc, mesh)
        q = Adist.shard_vector(np.asarray(ck.q), mesh)
        rng.bit_generator.state = ck.rng_state
        restart = nconv < config.n_wanted

    safe_key = jax.random.PRNGKey(config.seed)

    _EPS = float(np.finfo(np.float64).eps)

    while restart and n_restarts < config.max_restarts:
        n_restarts += 1
        b = np.zeros(iters)
        T: Optional[np.ndarray] = None
        blocks: List[jax.Array] = []

        # Zero-padded cycle history for FULL/PERIODIC reorth and for the
        # SELECTIVE Ritz-vector GEMM; slot j holds basis column j (m+1
        # columns incl. the trailing one), written after each block's own
        # orth step so a block never projects against itself.
        Qhist = (
            Adist.state_zeros(m + 1, mesh, hist_dtype)
            if orth in (Orth.FULL, Orth.PERIODIC, Orth.SELECTIVE)
            else None
        )
        omega = OmegaRecurrence(norm_A) if orth == Orth.PERIODIC else None
        # Selective: converged-Ritz basis at fixed padded width, appended
        # to Q_conv in the block projections (zero columns = no-ops).
        r_cap = config.n_wanted + 4
        QRpad = (
            Adist.state_zeros(r_cap, mesh, hist_dtype)
            if orth == Orth.SELECTIVE
            else None
        )
        nritz = 0
        norm_sqrt_eps = norm_A * np.sqrt(_EPS)

        def _proj_basis(Qc):
            if QRpad is None:
                return Qc
            return jnp.concatenate([Qc, QRpad], axis=1)

        qr_m = str(config.orth_params.qr_method.value)
        mp = bool(config.orth_params.mixed_precision)
        if nconv:
            # Deflate the cycle's start vector against the locked basis:
            # the powers block re-amplifies any locked component (largest
            # eigenvalues grow fastest), and the T recovery uses R factors
            # from BEFORE the Q_conv projection, so an un-deflated start
            # poisons the cycle's T and stalls convergence.
            q = _deflate_start(q, Qconv)
        safe_key, k1 = jax.random.split(safe_key)
        Qb, Rk, first_rank = _dist_first_block_locked(
            Adist, q, _proj_basis(Qconv), diag, sub, s, mesh, qr_m,
            safe=safe_qr, key=k1, mp=mp,
        )
        # Random-restart only on catastrophic first-block breakdown (the
        # start was an invariant direction); partial rank loss is ordinary
        # near-convergence conditioning and the cycle is still useful.
        breakdown = safe_qr and int(first_rank) <= 1
        blocks.append(Qb)
        # safe_qr: pinv-based T recovery keeps null directions at zero so
        # breakdown cannot fabricate plausible Ritz pairs (see _block._rdiv).
        rcond = 1e-10 if safe_qr else None
        T, b[0] = first_block_T(np.array(Rk, np.float64), Bk, s, rcond=rcond)
        if Qhist is not None:
            Qhist = Qhist.at[:, : s + 1].set(Qb)
        for k in range(2, iters + 1):
            safe_key, kk = jax.random.split(safe_key)
            Q_new, Rkk, R = _dist_ca_block_locked(
                Adist, blocks[-1], _proj_basis(Qconv), diag, sub, s, mesh, qr_m,
                safe=safe_qr, key=kk, mp=mp,
            )
            Tk, b[k - 1], _ = block_T(
                np.asarray(Rkk, np.float64), np.array(R, np.float64), Bk,
                b[k - 2], s, rcond=rcond,
            )
            T = extend_T(T, Tk, b[k - 2], b[k - 1], s)

            if orth == Orth.FULL:
                # Cleanup pass against everything before the previous
                # block (restarted_ca_lanczos.m:328-333 'fro' mode).
                Q_new = _dist_reorth(Qhist, Q_new, mesh, qr_m, mp=mp)
            elif orth == Orth.PERIODIC:
                alpha_d = np.diagonal(T[: s * k, : s * k]).copy()
                beta_d = np.diagonal(T[: s * k + 1, : s * k], -1).copy()
                omega.update(alpha_d, beta_d)
                if omega.max_error_block(s) >= np.sqrt(_EPS / (k * s)):
                    Q_new = _dist_reorth(Qhist, Q_new, mesh, qr_m)
                    omega.reset_block(s)

            if Qhist is not None:
                lo = (k - 1) * s + 1
                Qhist = Qhist.at[:, lo : lo + s].set(Q_new)
            blocks.append(jnp.concatenate([blocks[-1][:, -1:], Q_new], axis=1))

            if orth == Orth.SELECTIVE:
                # Ritz tracking (restarted_ca_lanczos.m:436-454): when new
                # pairs converge, rebuild the Ritz basis from the padded
                # history (orthonormal Q x orthonormal eigvecs stays
                # orthonormal, so no renormalization pass is needed).
                sk = s * k
                d_k, Vp_k = np.linalg.eigh(T[:sk, :sk])
                conv = [
                    i for i in range(sk)
                    if b[k - 1] * abs(Vp_k[sk - 1, i]) < norm_sqrt_eps
                ][:r_cap]
                if len(conv) > nritz:
                    nritz = len(conv)
                    for j, i in enumerate(conv):
                        w = np.zeros(m + 1)
                        w[:sk] = Vp_k[:, i]
                        y = _dist_ritz_vector(Qhist, jnp.asarray(w, dtype), mesh)
                        QRpad = QRpad.at[:, j].set(y)

        # Basis of this cycle (sharded), aligned with T's q0..q_{m-1}:
        # block 0 contributes ALL s+1 columns (q0..qs) and later blocks
        # their s new columns (first column repeats the previous block's
        # last).  Dropping block 0's last column instead would shift
        # every column >= s off by one against T — Ritz VALUES still come
        # out right (host math on T), but Ritz vectors assembled from the
        # shifted basis carry O(1) errors that the residual ESTIMATE
        # beta_m*|Vp[m-1]| cannot see (round-2 regression caught by
        # test_dist_auto's true-residual check).
        Q_cycle = jnp.concatenate(
            [blocks[0]] + [B[:, 1:] for B in blocks[1:]], axis=1
        )[:, :m]

        d, Vp = np.linalg.eigh(T[:m, :m])
        beta_m = T[m, m - 1]
        ritz_norms = beta_m * np.abs(Vp[m - 1, :])
        import os as _os
        if _os.environ.get("CAL_DEBUG_DIST"):
            _top = np.argsort(d)[::-1][:6]
            print(f"[cycle {n_restarts}] nconv={nconv} beta_m={beta_m:.2e} "
                  f"top d={np.round(d[_top],5)} rn={ritz_norms[_top]}",
                  flush=True)
        k_new, d, Vp, ritz_norms = _lock_converged(
            d, Vp, ritz_norms, tol, lam_bound=1.05 * norm_A
        )
        # The fixed-width Qconv can only hold lock_cap pairs: when more
        # converge in one cycle, keep the WANTED end — largest by default
        # (the reference locks all and trims to the largest at the end,
        # restarted_ca_lanczos.m:183-189), smallest for a SMALLEST run
        # (ADVICE r4: trimming to the largest there returns wrong-end
        # results with converged=True).
        if k_new > lock_cap - nconv:
            order = np.argsort(d[:k_new])
            if RestartStrategy(config.restart_strategy) != RestartStrategy.SMALLEST:
                order = order[::-1]
            keep = np.concatenate([order, np.arange(k_new, len(d))])
            d, Vp, ritz_norms = d[keep], Vp[:, keep], ritz_norms[keep]
            k_new = lock_cap - nconv

        # Loose true-residual sanity check before locking (see
        # solvers.restarted for the rationale and threshold).
        k_est = k_new  # estimate-converged prefix (locked OR rejected)
        verified = 0
        for i in range(k_new):
            x = _dist_ritz_vector(Q_cycle, jnp.asarray(Vp[:, i], dtype), mesh)
            true_abs = float(jnp.linalg.norm(_dist_spmv_any(Adist, x, mesh) - float(d[i]) * x))
            if config.verify_locked and true_abs > _verify_gate(
                    ritz_norms[i], norm_A,
                    floor=_verify_floor(dtype, config.tol, safe_qr=safe_qr)):
                continue
            Qconv = Qconv.at[:, nconv + verified].set(x)
            conv_eigs.append(float(d[i]))
            conv_rnorms.append(float(ritz_norms[i]))
            verified += 1
        k_new = verified
        rnorm_rows.append(
            np.asarray(conv_rnorms + [np.nan] * (config.n_wanted - len(conv_rnorms)))[
                : config.n_wanted
            ]
        )
        nconv += k_new
        # Stagnation detection (safe_qr mode only): the pinv-regularized
        # T recovery caps how far a Ritz-vector restart can refine, so a
        # safe run can orbit locklessly near the tolerance.  After
        # several lockless cycles, fall back to the reference's random
        # restart (restarted_ca_lanczos.m:204-248) instead of grinding
        # the same near-invariant start.  Plain runs keep unlimited
        # Ritz-refinement cycles — multi-cycle lockless stretches are
        # ordinary there and a random restart would discard progress.
        stall = stall + 1 if (safe_qr and k_new == 0) else 0

        # Stop only when n_wanted locked pairs DOMINATE every unconverged
        # estimate (the reference's commented-out intent,
        # restarted_ca_lanczos.m:255-261) — see solvers.restarted.
        restart = _wanted_converged(conv_eigs, d[k_est:],
                                    config.restart_strategy) < config.n_wanted
        if restart and (breakdown or stall >= _STALL_CYCLES):
            stall = 0
            # The cycle started on an (near-)invariant subspace: its
            # randomized T does not represent A on the refreshed columns,
            # so a Ritz restart vector would stall.  Start the next cycle
            # from a fresh random vector instead (the reference's random
            # restart strategy, restarted_ca_lanczos.m:204-248).
            q_h = rng.standard_normal(n)
            if nconv:
                Qc = Adist.gather_columns(Qconv)[:, :nconv]
                q_h = q_h - Qc @ (Qc.T @ q_h)
            q = Adist.shard_vector(q_h / np.linalg.norm(q_h), mesh)
        elif restart:
            # Start vector from the chosen non-converged Ritz vector
            # (restarted_ca_lanczos.m:177-180), computed on the mesh.
            strategy = RestartStrategy(config.restart_strategy)
            # Candidates start AFTER the whole estimate-converged prefix:
            # entries [verified, k_est) were either locked into Qconv
            # (restarting onto them would be deflated to noise) or
            # verify-rejected junk (their tiny ritz_norms would dominate
            # CLOSEST_CONV); neither is a useful restart direction.
            cand = d[k_est:]
            # Spectral-bound guard, same rationale as _lock_converged:
            # safe_qr basis refreshes can leave spurious Ritz values
            # beyond the spectrum (|d| > ||A||); restarting LARGEST onto
            # one wastes the next cycle on a junk direction.
            ok = np.abs(cand) <= 1.05 * norm_A
            if not np.any(ok):
                ok = np.ones(len(cand), bool)
            if len(cand) == 0:
                idx = m - 1
            elif strategy == RestartStrategy.SMALLEST:
                idx = k_est + int(np.argmin(np.where(ok, cand, np.inf)))
            elif strategy == RestartStrategy.CLOSEST_CONV:
                idx = k_est + int(
                    np.argmin(np.where(ok, ritz_norms[k_est:], np.inf))
                )
            elif strategy == RestartStrategy.RANDOM:
                idx = k_est + int(rng.choice(np.flatnonzero(ok)))
            else:
                idx = k_est + int(np.argmax(np.where(ok, cand, -np.inf)))
            q = _dist_ritz_vector(Q_cycle, jnp.asarray(Vp[:, idx], dtype), mesh)
            nrm = float(jnp.linalg.norm(q))
            q = q / nrm

        if checkpoint_path is not None:
            from ca_lanczos_tpu.utils.checkpoint import RestartCheckpoint

            RestartCheckpoint(
                n_restarts=n_restarts,
                nconv=nconv,
                conv_eigs=conv_eigs,
                conv_rnorms=conv_rnorms,
                orth_err=orth_err,
                rnorm_rows=rnorm_rows,
                Q_conv=Adist.gather_columns(Qconv)[:, :nconv] if nconv else None,
                q=Adist.gather_columns(q),
                Bk=np.asarray(Bk),
                rng_state=rng.bit_generator.state,
            ).save(checkpoint_path)

    Q_conv_final = Adist.gather_columns(Qconv)[:, :nconv] if nconv else None
    return _finalize(
        conv_eigs, conv_rnorms, Q_conv_final, n_restarts, rnorm_rows, [],
        config.n_wanted, not restart, strategy=config.restart_strategy,
    )
