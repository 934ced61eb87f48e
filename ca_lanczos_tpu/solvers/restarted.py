"""Explicitly-restarted (thick-restart) Lanczos and CA-Lanczos drivers.

Reference: restarted_lanczos.m and restarted_ca_lanczos.m (the flagship
driver of the reference, north-star config: nwanted=10, s=6, Newton basis,
local orth, tol = 1e-8 * normest(A), restarted_ca_lanczos.m:13-39).

Structure per restart cycle (restarted_ca_lanczos.m:83-181):

* run an inner (CA-)Lanczos sweep in which every block orthogonalization
  also projects against the locked converged basis ``Q_conv``
  (restarted_ca_lanczos.m:315,324,333);
* Ritz residual estimates ``beta * |y_i[end]|`` from eig(T)
  (restarted_ca_lanczos.m:110-116);
* converged pairs (residual < tol) are swapped to the front, their Ritz
  vectors locked into ``Q_conv`` (restarted_ca_lanczos.m:119-139);
* the next start vector is built from a non-converged Ritz vector
  according to the restart strategy (restarted_ca_lanczos.m:204-248).

All large-array work (matrix powers, block orth, Ritz-vector assembly)
runs on device; the restart-control state machine, eig(T) and the omega
recurrence are host float64 math.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.config import Basis, LanczosConfig, Orth, OrthParams, RestartStrategy
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers
from ca_lanczos_tpu.ops.orth import normalize, project, project_and_normalize
from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.ops.spmv import Operator, normest, spmv
from ca_lanczos_tpu.solvers._block import block_T, extend_T, first_block_T
from ca_lanczos_tpu.solvers.ca_lanczos import build_basis_matrix
from ca_lanczos_tpu.utils.diagnostics import OmegaRecurrence, orth_error_fro

_EPS = float(np.finfo(np.float64).eps)
_SQRT_EPS = float(np.sqrt(_EPS))


@dataclasses.dataclass
class RestartedResult:
    """Converged eigenpairs of a restarted driver.

    eigs: converged eigenvalues, descending (restarted_ca_lanczos.m:183-201).
    Q_conv: locked Ritz vectors, columns matching ``eigs``.
    n_restarts: restart cycles executed.
    conv_rnorms: residual estimates at lock time.
    rnorms: per-restart relative residual matrix (restarted_ca_lanczos.m:141-162).
    orth_err: per-restart ||I - Q^H Q||_F (restarted_ca_lanczos.m:164-168).
    converged: whether n_wanted pairs converged within max_restarts.
    """

    eigs: np.ndarray
    Q_conv: Optional[jax.Array]
    n_restarts: int
    conv_rnorms: np.ndarray
    rnorms: np.ndarray
    orth_err: np.ndarray
    converged: bool


def _generate_start_vector(
    d: np.ndarray,
    Vp: np.ndarray,
    Q_new: jax.Array,
    ritz_norms: np.ndarray,
    k: int,
    strategy: RestartStrategy,
    rng: np.random.Generator,
    lam_bound: float = None,
) -> jax.Array:
    """Next restart vector from the non-converged Ritz vectors
    (restarted_ca_lanczos.m:204-248); indices >= k are non-converged.

    lam_bound: Ritz values with |d| > lam_bound are never chosen —
    basis breakdown (low precision, ill-conditioned monomial blocks)
    can fabricate Ritz values beyond the spectral interval, and
    restarting LARGEST onto one wastes the next cycle on a junk
    direction (same guard rationale as _lock_converged)."""
    m = len(d)
    strategy = RestartStrategy(strategy)
    ok = (
        np.abs(d[k:]) <= lam_bound
        if lam_bound is not None
        else np.ones(max(m - k, 0), bool)
    )
    if not np.any(ok):
        ok = np.ones(max(m - k, 0), bool)
    if k >= m:  # everything converged this sweep; caller stops anyway
        idx = m - 1
    elif strategy == RestartStrategy.LARGEST:
        idx = k + int(np.argmax(np.where(ok, d[k:], -np.inf)))
    elif strategy == RestartStrategy.SMALLEST:
        idx = k + int(np.argmin(np.where(ok, d[k:], np.inf)))
    elif strategy == RestartStrategy.CLOSEST_CONV:
        # Reference scans k+2..m seeded at ix=k+1 (restarted_ca_lanczos.m:231-239).
        idx = k + int(np.argmin(np.where(ok, ritz_norms[k:], np.inf)))
    else:  # RANDOM
        idx = k + int(rng.choice(np.flatnonzero(ok)))
    q = mm(Q_new, jnp.asarray(Vp[:, idx], Q_new.dtype))
    return q / jnp.linalg.norm(q)


def _wanted_converged(conv_eigs, d_unconv, strategy=None) -> int:
    """Count locked eigenvalues that DOMINATE every unconverged Ritz
    estimate of the current cycle — the stop criterion the reference
    author wrote but left commented out (restarted_ca_lanczos.m:255-261;
    the committed code stops on the raw converged COUNT).  Lanczos
    converges both spectrum ends, so the raw count can fill the wanted
    set with bottom-end pairs and silently return the wrong answer for
    'largest' (observed on a tight-top-cluster Hamiltonian: 7 top + 3
    most-negative pairs reported as the top 10).  Deliberate divergence:
    we lock every converged pair (deflation is still useful) but only
    pairs above all unconverged estimates count as WANTED.

    strategy: SMALLEST inverts the dominance test; CLOSEST_CONV/RANDOM
    have no defined wanted end, so the raw reference count applies."""
    if len(d_unconv) == 0:
        return len(conv_eigs)
    if strategy == RestartStrategy.SMALLEST:
        return int(np.sum(np.asarray(conv_eigs) < float(np.min(d_unconv))))
    if strategy in (RestartStrategy.CLOSEST_CONV, RestartStrategy.RANDOM):
        return len(conv_eigs)
    return int(np.sum(np.asarray(conv_eigs) > float(np.max(d_unconv))))


def _lock_converged(d, Vp, ritz_norms, tol, lam_bound=None):
    """Stable partition: converged Ritz indices first, preserving the
    reference's swap-to-front semantics (restarted_ca_lanczos.m:119-132).

    lam_bound: when given, Ritz values with |d| > lam_bound are never
    locked — values outside the spectral interval are numerical artifacts
    of basis breakdown (their residual ESTIMATE can be spuriously tiny),
    a guard the reference lacks but low-precision runs need."""
    def ok(i):
        if ritz_norms[i] >= tol:
            return False
        return lam_bound is None or abs(d[i]) <= lam_bound
    conv = [i for i in range(len(d)) if ok(i)]
    nonconv = [i for i in range(len(d)) if not ok(i)]
    order = conv + nonconv
    return len(conv), d[order], Vp[:, order], ritz_norms[order]


def _verify_gate(rn_est: float, norm_A: float, floor: float = 1e-4) -> float:
    """Acceptance threshold for the true-residual check at lock time.

    Principle: a lock is rejected when the TRUE residual is inconsistent
    with the ESTIMATE by orders of magnitude — 1e3x covers legitimate
    orthogonality drift (LOCAL-orth runs where the reference also locks,
    lanczos.m/ca_lanczos.m semantics).  The old catastrophic-only gate
    (1e-2*||A||) accepted a ghost pair whose estimate lied by six orders
    (true residual 3e-4*||A|| at tol 1e-9*||A||, graded-Poisson corpus
    case) — the estimate-consistency form rejects it while keeping every
    healthy corpus lock.

    floor: relative floor on the gate — see _verify_floor; 1e-3 for f32
    state (f32 basis storage at the >=4M-row scale carries legitimate
    ~1e-4*||A|| lock residuals); breakdown-recovery (safe_qr) cycles
    pass 1e-2, the old catastrophic-only level, because pinv-regularized
    refreshed bases produce honest locks whose estimates legitimately
    undershoot."""
    return max(1e3 * float(rn_est), floor * norm_A)


def _verify_floor(dtype, tol_rel: float, safe_qr: bool = False) -> float:
    """Relative floor for _verify_gate by state dtype and requested
    tolerance.  f64 scales with the caller's tolerance,
    max(1e-7, 100*tol_rel): the old fixed 1e-4 floor let a GHOST pair
    (estimate 1e-12, true residual 7e-5 relative) lock as converged on a
    tol=1e-9 graded-Poisson run — a tol=1e-9 caller cares about
    1e-7-grade truth, while a loose-tol caller keeps the old slack.
    f32 keeps 1e-3 (the legitimate at-scale storage drift); safe_qr
    keeps the catastrophic-only 1e-2 (see _verify_gate)."""
    import jax.numpy as _jnp

    if safe_qr:
        return 1e-2
    if dtype == _jnp.float32:
        return 1e-3
    return max(1e-7, 100.0 * float(tol_rel))


def _relative_residual(A: Operator, x: jax.Array, lam: float) -> float:
    num = jnp.linalg.norm(spmv(A, x) - lam * x)
    den = abs(lam) * jnp.linalg.norm(x)
    return float(num / den)


# ---------------------------------------------------------------------------
# Standard restarted Lanczos (restarted_lanczos.m)
# ---------------------------------------------------------------------------


def _std_inner(
    A: Operator,
    Q_conv: Optional[jax.Array],
    q: jax.Array,
    maxiter: int,
    orth: Orth,
    norm_A: float,
    params: OrthParams,
):
    """Inner Lanczos sweep projecting against the converged basis
    (restarted_lanczos.m:223-350).  Returns (Q (n, m), T_ext ((m+1), m))."""
    n = q.shape[0]
    dtype = q.dtype
    Q = jnp.zeros((n, maxiter + 1), dtype).at[:, 0].set(q)
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)

    omega = OmegaRecurrence(norm_A) if orth == Orth.PERIODIC else None
    norm_sqrt_eps = norm_A * _SQRT_EPS
    QR: Optional[jax.Array] = None
    nritz = 0

    conv_blocks = [Q_conv] if Q_conv is not None and Q_conv.size else []

    for j in range(1, maxiter + 1):
        r = spmv(A, Q[:, j - 1])
        if j > 1:
            r = r - jnp.asarray(beta[j - 2], dtype) * Q[:, j - 2]
        # Project against {q_j, Q_conv[, history]}; alpha_j is the q_j
        # coefficient (restarted_lanczos.m:243-248).
        blocks = [Q[:, j - 1 : j]] + conv_blocks
        if orth == Orth.FULL:
            blocks = blocks + [Q[:, : j - 1]] if j > 1 else blocks
        elif orth == Orth.SELECTIVE and nritz > 0:
            blocks = blocks + [QR]
        r, R_blocks = project(blocks, r, reorth=True, params=params)
        alpha[j - 1] = float(np.real(R_blocks[0][0, 0]))
        b_j = float(jnp.linalg.norm(r))
        beta[j - 1] = b_j
        Q = Q.at[:, j].set(r / b_j)

        if orth == Orth.SELECTIVE:
            # Converged-Ritz monitoring (restarted_lanczos.m:284-302).
            T = _tridiag(alpha[:j], beta[:j])
            d, Vp = np.linalg.eigh(T)
            conv = [i for i in range(j) if beta[j - 1] * abs(Vp[j - 1, i]) < norm_sqrt_eps]
            if len(conv) > nritz:
                nritz = len(conv)
                Vc = jnp.asarray(Vp[:, conv], dtype)
                QR, _, _ = normalize(mm(Q[:, :j], Vc), params=params)
        elif orth == Orth.PERIODIC:
            # Full-matrix error test (restarted_lanczos.m:336-342).
            om = omega.update(alpha[:j], beta[:j])
            err = float(np.max(np.abs(om - np.eye(om.shape[0]))))
            if err >= norm_sqrt_eps:
                prev = [Q[:, : j - 1]] + conv_blocks if j > 1 else conv_blocks
                res = project_and_normalize(prev, Q[:, j - 1 : j + 1], reorth=True, params=params)
                Q = Q.at[:, j - 1 : j + 1].set(res.Q)
                omega.reset_scalar()

    T_ext = np.zeros((maxiter + 1, maxiter))
    T_ext[:maxiter] = _tridiag(alpha, beta)
    T_ext[maxiter, maxiter - 1] = beta[maxiter - 1]
    return Q[:, :maxiter], T_ext


def _tridiag(alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    m = len(alpha)
    T = np.diag(alpha)
    if m > 1:
        T += np.diag(beta[: m - 1], 1) + np.diag(beta[: m - 1], -1)
    return T


def restarted_lanczos(
    A: Operator,
    r: jax.Array,
    max_lanczos: int,
    n_wanted: int = 10,
    orth: Orth = Orth.LOCAL,
    tol: float = 1.0e-6,
    max_restarts: int = 100,
    restart_strategy: RestartStrategy = RestartStrategy.LARGEST,
    params: OrthParams = OrthParams(),
    seed: int = 0,
    verify_locked: bool = True,
) -> RestartedResult:
    """Thick-restart standard Lanczos (restarted_lanczos.m:6-149).

    tol is scaled by normest(A) (restarted_lanczos.m:31-35); each restart
    runs ``max_lanczos - nconv`` steps (restarted_lanczos.m:69).
    verify_locked: loose true-residual sanity check at lock time (see
    restarted_ca_lanczos).
    """
    orth = Orth(orth)
    norm_A = normest(A)
    tol = tol * norm_A
    rng = np.random.default_rng(seed)

    q = r / jnp.linalg.norm(r)
    dtype = q.dtype

    Q_conv: Optional[jax.Array] = None
    conv_eigs: List[float] = []
    conv_rnorms: List[float] = []
    orth_err: List[float] = []
    rnorm_rows: List[np.ndarray] = []

    nconv = 0
    n_restarts = 0
    restart = True
    while restart and n_restarts < max_restarts:
        n_restarts += 1
        iters = max_lanczos - nconv
        Q_new, T_ext = _std_inner(A, Q_conv, q, iters, orth, norm_A, params)

        d, Vp = np.linalg.eigh(T_ext[:iters, :iters])
        beta_m = T_ext[iters, iters - 1]
        # + eps*norm_A floor per restarted_lanczos.m:95.
        ritz_norms = beta_m * np.abs(Vp[iters - 1, :]) + _EPS * norm_A

        k, d, Vp, ritz_norms = _lock_converged(d, Vp, ritz_norms, tol)

        Qblocks = [Q_conv, Q_new] if Q_conv is not None else [Q_new]
        orth_err.append(orth_error_fro(jnp.concatenate(Qblocks, axis=1)))

        k_est = k  # estimate-converged prefix (locked OR verify-rejected)
        verified = 0
        for i in range(k):
            x = mm(Q_new, jnp.asarray(Vp[:, i], dtype))
            if verify_locked:
                true_abs = float(jnp.linalg.norm(spmv(A, x) - float(d[i]) * x))
                if true_abs > _verify_gate(
                        ritz_norms[i], norm_A,
                        floor=_verify_floor(dtype, tol / norm_A)):
                    continue
            conv_eigs.append(float(d[i]))
            conv_rnorms.append(float(ritz_norms[i]))
            Q_conv = x[:, None] if Q_conv is None else jnp.concatenate([Q_conv, x[:, None]], axis=1)
            verified += 1
        k = verified
        nconv += k
        rnorm_rows.append(np.asarray(conv_rnorms + [np.nan] * (n_wanted - len(conv_rnorms)))[:n_wanted])

        restart = _wanted_converged(conv_eigs, d[k_est:], restart_strategy) < n_wanted
        if restart:
            # Candidates start after the WHOLE estimate-converged prefix
            # (k_est): entries [k, k_est) are locked pairs or verify-
            # rejected junk, and restarting onto either wastes a cycle.
            q = _generate_start_vector(d, Vp, Q_new, ritz_norms, k_est,
                                       restart_strategy, rng,
                                       lam_bound=1.05 * norm_A)
            # Purge converged directions (restarted_lanczos.m:129).
            if Q_conv is not None:
                q, _ = project([Q_conv], q, reorth=True, params=params)
                q = q / jnp.linalg.norm(q)

    return _finalize(
        conv_eigs, conv_rnorms, Q_conv, n_restarts, rnorm_rows, orth_err, n_wanted, not restart,
        strategy=restart_strategy,
    )


def _finalize(conv_eigs, conv_rnorms, Q_conv, n_restarts, rnorm_rows, orth_err, n_wanted, converged, strategy=None):
    """Sort toward the wanted end and trim (restarted_ca_lanczos.m:183-201).

    strategy: the run's RestartStrategy.  SMALLEST sorts ascending and
    keeps the smallest locked pairs — without this, a SMALLEST run that
    incidentally locked top-end pairs (Lanczos converges both spectrum
    ends) would trim to the LARGEST and return wrong-end results with
    converged=True (ADVICE r4 medium).  All other strategies keep the
    reference's descending order."""
    eigs = np.asarray(conv_eigs)
    rn = np.asarray(conv_rnorms)
    keep = min(n_wanted, len(eigs)) if converged else len(eigs)
    ascending = strategy is not None and RestartStrategy(strategy) == RestartStrategy.SMALLEST
    order = np.argsort(eigs) if ascending else np.argsort(eigs)[::-1]
    eigs, rn = eigs[order][:keep], rn[order][:keep]
    if Q_conv is not None and len(order):
        Q_conv = Q_conv[:, np.asarray(order)][:, :keep]
    return RestartedResult(
        eigs=eigs,
        Q_conv=Q_conv,
        n_restarts=n_restarts,
        conv_rnorms=rn,
        rnorms=np.asarray(rnorm_rows) if rnorm_rows else np.zeros((0, n_wanted)),
        orth_err=np.asarray(orth_err),
        converged=converged,
    )


# ---------------------------------------------------------------------------
# Restarted CA-Lanczos (restarted_ca_lanczos.m) — the flagship driver
# ---------------------------------------------------------------------------


def _ca_inner(
    A: Operator,
    Q_conv: Optional[jax.Array],
    q: jax.Array,
    Bk: np.ndarray,
    iters: int,
    s: int,
    basis: Basis,
    orth: Orth,
    norm_A: float,
    params: OrthParams,
):
    """One restart cycle of CA blocks, locked against Q_conv
    (restarted_ca_lanczos.m:288-552).  Returns (Q (n, s*iters),
    T_ext ((s*iters+1), s*iters))."""
    n = q.shape[0]
    dtype = q.dtype
    Q = jnp.zeros((n, iters * s + 1), dtype)
    b = np.zeros(iters)
    T: Optional[np.ndarray] = None

    conv_blocks = [Q_conv] if Q_conv is not None and Q_conv.size else []
    omega = OmegaRecurrence(norm_A) if orth == Orth.PERIODIC else None
    norm_sqrt_eps = norm_A * _SQRT_EPS
    QR: Optional[jax.Array] = None
    nritz = 0

    for k in range(1, iters + 1):
        qk = Q[:, (k - 1) * s] if k > 1 else q
        V = matrix_powers(A, qk, s, Bk, basis)

        if k == 1:
            # normalize, then lock against Q_conv; T from the normalize R
            # only (restarted_ca_lanczos.m:311-319).  NOTE: null-space
            # randomization is deliberately NOT enabled here — the Tk
            # recurrence consumes these R factors, and randomized columns
            # no longer satisfy V = Q R (spurious locks are instead
            # filtered by the true-residual check at lock time).
            Qb, Rk, _ = normalize(V, params=params)
            if conv_blocks:
                res = project_and_normalize(conv_blocks, Qb, reorth=True, params=params)
                Qb = res.Q
            Q = Q.at[:, : s + 1].set(Qb)
            T, b[0] = first_block_T(Rk, Bk, s)
        else:
            prev = Q[:, (k - 2) * s : (k - 1) * s + 1]
            if orth == Orth.FULL:
                # R factors from the previous-block pass; the full history +
                # Q_conv pass is orthogonalization only
                # (restarted_ca_lanczos.m:328-333).
                res = project_and_normalize([prev], V[:, 1 : s + 1], reorth=True, params=params)
                hist = conv_blocks + ([Q[:, : (k - 2) * s]] if k > 2 else [])
                Qb = res.Q
                if hist:
                    res2 = project_and_normalize(hist, Qb, reorth=True, params=params)
                    Qb = res2.Q
                Q = Q.at[:, (k - 1) * s + 1 : k * s + 1].set(Qb)
            else:
                blocks = [prev] + conv_blocks
                if orth == Orth.SELECTIVE and nritz > 0:
                    blocks = blocks + [QR]
                res = project_and_normalize(blocks, V[:, 1 : s + 1], reorth=True, params=params)
                Q = Q.at[:, (k - 1) * s + 1 : k * s + 1].set(res.Q[:, :s])

            Tk, b[k - 1], _ = block_T(res.R_blocks[0], res.R, Bk, b[k - 2], s)
            T = extend_T(T, Tk, b[k - 2], b[k - 1], s)

        if orth == Orth.SELECTIVE:
            # Ritz tracking per block (restarted_ca_lanczos.m:436-454).
            d, Vp = np.linalg.eigh(T[: s * k, : s * k])
            conv = [i for i in range(s * k) if b[k - 1] * abs(Vp[s * k - 1, i]) < norm_sqrt_eps]
            if len(conv) > nritz:
                nritz = len(conv)
                Vc = jnp.asarray(Vp[:, conv], dtype)
                QR, _, _ = normalize(mm(Q[:, : s * k], Vc), params=params)
        elif orth == Orth.PERIODIC:
            # Blocked omega recurrence; trigger sqrt(eps/(k*s))
            # (restarted_ca_lanczos.m:531-546).
            alpha_d = np.diagonal(T[: s * k, : s * k]).copy()
            beta_d = np.diagonal(T[: s * k + 1, : s * k], -1).copy()
            omega.update(alpha_d, beta_d)
            if k > 1 and omega.max_error_block(s) >= np.sqrt(_EPS / (k * s)):
                lo = (k - 1) * s
                res = project_and_normalize(
                    [Q[:, :lo]] + conv_blocks, Q[:, lo : k * s + 1], reorth=True, params=params
                )
                Q = Q.at[:, lo : k * s + 1].set(res.Q)
                omega.reset_block(s)

    m = s * iters
    T_ext = T[: m + 1, :m].copy()
    return Q[:, :m], T_ext


def restarted_ca_lanczos(
    A: Operator,
    r: jax.Array,
    max_lanczos: int,
    config: LanczosConfig = LanczosConfig(),
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
) -> RestartedResult:
    """Explicitly-restarted CA-Lanczos — the reference's flagship driver
    (restarted_ca_lanczos.m:4-202).

    max_lanczos is the Krylov budget per restart cycle; each cycle runs
    floor(max_lanczos / s) CA blocks (restarted_ca_lanczos.m:89).

    checkpoint_path: if given, the full restart state is serialized at
    every restart boundary (utils.checkpoint); resume_from continues an
    interrupted run from such a file.
    """
    from ca_lanczos_tpu.utils.checkpoint import RestartCheckpoint

    s = config.s
    basis = Basis(config.basis)
    orth = Orth(config.orth)
    params = config.orth_params
    norm_A = normest(A)
    tol = config.tol * norm_A
    rng = np.random.default_rng(config.seed)

    q = r / jnp.linalg.norm(r)
    dtype = q.dtype

    Q_conv: Optional[jax.Array] = None
    conv_eigs: List[float] = []
    conv_rnorms: List[float] = []
    orth_err: List[float] = []
    rnorm_rows: List[np.ndarray] = []
    nconv = 0
    n_restarts = 0

    if resume_from is not None:
        ck = RestartCheckpoint.load(resume_from)
        n_restarts = ck.n_restarts
        nconv = ck.nconv
        conv_eigs = list(ck.conv_eigs)
        conv_rnorms = list(ck.conv_rnorms)
        orth_err = list(ck.orth_err)
        rnorm_rows = list(ck.rnorm_rows)
        Q_conv = jnp.asarray(ck.Q_conv, dtype) if ck.Q_conv is not None else None
        q = jnp.asarray(ck.q, dtype)
        Bk = ck.Bk
        rng.bit_generator.state = ck.rng_state
    else:
        Bk = build_basis_matrix(A, q, s, basis, bootstrap_orth=Orth.LOCAL)

    restart = nconv < config.n_wanted
    iters = max_lanczos // s
    if iters == 0:
        raise ValueError(f"max_lanczos={max_lanczos} < s={s}")

    while restart and n_restarts < config.max_restarts:
        n_restarts += 1
        Q_new, T_ext = _ca_inner(A, Q_conv, q, Bk, iters, s, basis, orth, norm_A, params)

        m = s * iters
        d, Vp = np.linalg.eigh(T_ext[:m, :m])
        beta_m = T_ext[m, m - 1]
        ritz_norms = beta_m * np.abs(Vp[m - 1, :])  # restarted_ca_lanczos.m:110-116

        k, d, Vp, ritz_norms = _lock_converged(
            d, Vp, ritz_norms, tol, lam_bound=1.05 * norm_A
        )

        Qblocks = [Q_conv, Q_new] if Q_conv is not None else [Q_new]
        orth_err.append(orth_error_fro(jnp.concatenate(Qblocks, axis=1)))

        # Sanity-check each candidate's TRUE residual before locking: past
        # in-cycle convergence the recurrence breaks down, T decouples, and
        # the beta*|y(end)| estimate goes spuriously tiny for garbage pairs.
        # The threshold is deliberately loose (1% of ||A||): local-orth
        # Lanczos legitimately locks pairs whose vector residual exceeds
        # the value-level estimate by the orthogonality drift (the
        # reference accepts those too); only catastrophic lies — values
        # outside/at the wrong end of the spectrum riding a fake-zero
        # estimate — are rejected.  One SpMV per candidate.
        row = np.full(config.n_wanted, np.nan)
        k_est = k  # estimate-converged prefix (locked OR verify-rejected)
        verified = 0
        for i in range(k):
            x = mm(Q_new, jnp.asarray(Vp[:, i], dtype))
            true_abs = float(jnp.linalg.norm(spmv(A, x) - float(d[i]) * x))
            if config.verify_locked and true_abs > _verify_gate(
                    ritz_norms[i], norm_A,
                    floor=_verify_floor(dtype, config.tol)):
                continue  # estimate lied; leave the pair unlocked
            conv_eigs.append(float(d[i]))
            conv_rnorms.append(float(ritz_norms[i]))
            if nconv + verified < config.n_wanted:
                row[nconv + verified] = _relative_residual(A, x, float(d[i]))
            Q_conv = x[:, None] if Q_conv is None else jnp.concatenate([Q_conv, x[:, None]], axis=1)
            verified += 1
        # Non-converged leaders fill the rest of the diagnostics row
        # (restarted_ca_lanczos.m:154-159).
        nc_order = np.argsort(d[k:])[::-1]
        for j, i in enumerate(nc_order[: max(0, config.n_wanted - nconv - verified)]):
            x = mm(Q_new, jnp.asarray(Vp[:, k + i], dtype))
            row[nconv + verified + j] = _relative_residual(A, x, float(d[k + i]))
        rnorm_rows.append(row)

        k = verified
        nconv += k
        restart = _wanted_converged(conv_eigs, d[k_est:],
                                    config.restart_strategy) < config.n_wanted
        if restart:
            # see restarted_lanczos: skip the whole [verified, k_est)
            # prefix of locked/rejected candidates
            q = _generate_start_vector(d, Vp, Q_new, ritz_norms, k_est,
                                       config.restart_strategy, rng,
                                       lam_bound=1.05 * norm_A)

        if checkpoint_path is not None:
            RestartCheckpoint(
                n_restarts=n_restarts,
                nconv=nconv,
                conv_eigs=conv_eigs,
                conv_rnorms=conv_rnorms,
                orth_err=orth_err,
                rnorm_rows=rnorm_rows,
                Q_conv=np.asarray(Q_conv) if Q_conv is not None else None,
                q=np.asarray(q),
                Bk=np.asarray(Bk),
                rng_state=rng.bit_generator.state,
            ).save(checkpoint_path)

    return _finalize(
        conv_eigs, conv_rnorms, Q_conv, n_restarts, rnorm_rows, orth_err, config.n_wanted, not restart,
        strategy=config.restart_strategy,
    )
