"""Lanczos time propagators for quantum dynamics: psi(t+dt) ~ Q expm(-i dt T) e1 ||psi||.

Reference: lanczos_prop.m, ca_lanczos_prop.m, and the experiment driver
runLanczos.m (1-D harmonic oscillator, N=512, dt=0.025, 200 steps, s=6,
24 Krylov steps, residual tol 1e-10).

Dtype note: the wavefunction is complex while the Hamiltonian is real
symmetric.  On CPU (and for parity tests) the Krylov recurrence runs in
native complex128; the split paths run the SpMV on a stacked (n, 2)
real view (re/im columns ride the same kernel) — the DIA/ELL
matvecs accept multivectors, so ``spmv(H, psi_ri)`` is the split form.

The small-T exponential uses the eigendecomposition of the (symmetrized)
tridiagonal T: expm(-i dt T) = V diag(exp(-i dt d)) V^T — exact for the
standard Lanczos T; for the CA T (near-symmetric up to roundoff) we use
scipy's expm of the unsymmetric T, matching expm() in ca_lanczos_prop.m:122.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg
from jax import lax

from ca_lanczos_tpu.ops.precision import mm, vdot
from ca_lanczos_tpu.basis.leja import leja
from ca_lanczos_tpu.basis.newton import newton_basis_matrix
from ca_lanczos_tpu.config import Basis, LejaVariant, Orth
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_from_B, matrix_powers_monomial
from ca_lanczos_tpu.ops.orth import normalize, project_and_normalize
from ca_lanczos_tpu.ops.spmv import Operator, spmv
from ca_lanczos_tpu.solvers._block import block_T, extend_T, first_block_T
from ca_lanczos_tpu.solvers.ca_lanczos import monomial_basis_matrix
from ca_lanczos_tpu.solvers.lanczos import lanczos


@dataclasses.dataclass
class PropResult:
    """Krylov factorization for one propagation step.

    T: real (m, m) projection matrix; Q: (n, m) complex basis;
    n_steps: Krylov dimension actually built; residual: last residual
    estimate |dt * beta * [expm(-i dt T)]_{m,1} * ||psi|||.
    """

    T: np.ndarray
    Q: jax.Array
    n_steps: int
    residual: float

    def apply_exp(self, dt: float, nrm: float) -> jax.Array:
        """psi(t+dt) = Q expm(-i dt T) e1 * ||psi|| (runLanczos.m:102)."""
        m = self.T.shape[0]
        E = _expm_tridiag(self.T, dt)
        coeff = jnp.asarray(E[:m, 0] * nrm, self.Q.dtype)
        return mm(self.Q, coeff)


def _expm_tridiag(T: np.ndarray, dt: float) -> np.ndarray:
    """expm(-i dt T) for small T (host).  Symmetric T goes through eigh
    (exact); general T through scipy (ca_lanczos_prop.m:122)."""
    T = np.asarray(T, np.float64)
    if np.allclose(T, T.T, atol=1e-12 * max(1.0, np.abs(T).max())):
        d, V = np.linalg.eigh(T)
        return (V * np.exp(-1j * dt * d)) @ V.T
    return scipy.linalg.expm(-1j * dt * T)


@jax.jit
def _prop_step(H: Operator, qj: jax.Array, qjm1: jax.Array, beta_prev: jax.Array):
    """One complex Lanczos step (lanczos_prop.m:31-41)."""
    r = spmv(H, qj) - beta_prev * qjm1
    alpha = jnp.real(vdot(qj, r))
    r = r - alpha * qj
    beta = jnp.linalg.norm(r)
    return r / beta, alpha, beta


def lanczos_prop(
    H: Operator,
    r0: jax.Array,
    maxiter: int,
    dt: float,
    tol: float = 1.0e-10,
    adaptive: bool = False,
) -> PropResult:
    """Krylov approximation of exp(-i dt H) psi (lanczos_prop.m:15-61).

    With ``adaptive`` the iteration stops as soon as the residual
    |dt * beta_j * [expm(-i dt T_j)]_{j,1} * ||psi||| drops below tol
    (lanczos_prop.m:44-55)."""
    r0 = jnp.asarray(r0)
    if not jnp.iscomplexobj(r0):
        r0 = r0.astype(jnp.complex128)
    n = r0.shape[0]
    nrm = float(jnp.linalg.norm(r0))
    q = r0 / nrm

    Q = jnp.zeros((n, maxiter + 1), r0.dtype).at[:, 0].set(q)
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)
    residual = np.inf
    j = 0
    for j in range(1, maxiter + 1):
        qj = Q[:, j - 1]
        qjm1 = Q[:, j - 2] if j > 1 else jnp.zeros_like(qj)
        bprev = jnp.asarray(beta[j - 2] if j > 1 else 0.0, jnp.float64)
        qn, a, b = _prop_step(H, qj, qjm1, bprev)
        alpha[j - 1] = float(a)
        beta[j - 1] = float(b)
        Q = Q.at[:, j].set(qn)
        if j >= 3:
            T = _tridiag(alpha[:j], beta[:j])
            E = _expm_tridiag(T, dt)
            residual = abs(dt * beta[j - 1] * E[j - 1, 0] * nrm)
            if residual < tol and adaptive:
                break

    T = _tridiag(alpha[:j], beta[:j])
    return PropResult(T=T, Q=Q[:, :j], n_steps=j, residual=float(residual))


def _tridiag(alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    m = len(alpha)
    T = np.diag(alpha)
    if m > 1:
        T += np.diag(beta[: m - 1], 1) + np.diag(beta[: m - 1], -1)
    return T


def ca_lanczos_prop(
    A: Operator,
    r0: jax.Array,
    s: int,
    m: int,
    dt: float,
    tol: float = 1.0e-10,
    basis: Basis = Basis.NEWTON,
    eigest: Optional[np.ndarray] = None,
    adaptive: bool = False,
) -> PropResult:
    """CA propagator: one block of s SpMVs per orthogonalization round
    (ca_lanczos_prop.m:3-135).

    ``eigest`` supplies basis eigenvalue estimates, skipping the 2s-step
    Lanczos bootstrap (ca_lanczos_prop.m:31-39).  Newton shifts come from
    the single-arg leja path — nonmodified ordering of the real parts
    (ca_lanczos_prop.m:40) — and the NONmodified newton basis matrix
    (modifiedp=0, ca_lanczos_prop.m:41).
    """
    basis = Basis(basis)
    r0 = jnp.asarray(r0)
    if not jnp.iscomplexobj(r0):
        r0 = r0.astype(jnp.complex128)
    n = r0.shape[0]
    nrm = float(jnp.linalg.norm(r0))
    q = r0 / nrm

    if basis == Basis.MONOMIAL:
        Bk = monomial_basis_matrix(s)
    else:
        if eigest is None:
            boot = lanczos(A, r0, 2 * s, Orth.LOCAL)
            basis_eigs = np.linalg.eigvalsh(boot.T)
        else:
            basis_eigs = np.asarray(eigest)
        shifts = leja(np.real(basis_eigs), LejaVariant.NONMODIFIED)
        Bk = newton_basis_matrix(shifts, s, modified=False)

    blocks: List[jax.Array] = []
    b = np.zeros(m)
    T: Optional[np.ndarray] = None
    residual = np.inf
    k = 0

    while k < m:
        k += 1
        if k > 1:
            q = blocks[-1][:, s]

        if basis == Basis.MONOMIAL:
            V = matrix_powers_monomial(A, q, s)
        else:
            V = matrix_powers_from_B(A, q, Bk)

        if k == 1:
            Qb, Rk, _ = normalize(V)
            blocks.append(Qb)
            T, b[0] = first_block_T(Rk, Bk, s)
        else:
            # No conditional second pass (reorth=False,
            # ca_lanczos_prop.m:78).
            res = project_and_normalize([blocks[-1]], V[:, 1 : s + 1], reorth=False)
            Tk, b[k - 1], _ = block_T(res.R_blocks[0], res.R, Bk, b[k - 2], s)
            T = extend_T(T, Tk, b[k - 2], b[k - 1], s)
            blocks.append(jnp.concatenate([blocks[-1][:, s : s + 1], res.Q], axis=1))

        # Residual from the exponential of the current T
        # (ca_lanczos_prop.m:120-128).
        Tsq = np.real(T[: k * s, : k * s])
        E = _expm_tridiag(Tsq, dt)
        residual = abs(dt * b[k - 1] * E[k * s - 1, 0] * nrm)
        if residual < tol and k * s >= 3 and adaptive:
            break

    # Assemble the basis (ca_lanczos_prop.m:131-134): block 1 contributes
    # its s+1 columns, later blocks their s NEW columns (their column 0 is
    # the previous block's last column, stored twice); trim to k*s.
    cols = [blocks[0]]
    for Bq in blocks[1:]:
        cols.append(Bq[:, 1 : s + 1])
    Q = jnp.concatenate(cols, axis=1)[:, : k * s]
    return PropResult(
        T=np.real(T[: k * s, : k * s]), Q=Q, n_steps=k * s, residual=float(residual)
    )


def propagate(
    H: Operator,
    psi0: jax.Array,
    dt: float,
    n_steps: int,
    krylov_dim: int = 24,
    method: str = "lanczos",
    s: int = 6,
    tol: float = 1.0e-10,
    basis: Basis = Basis.NEWTON,
    eigest: Optional[np.ndarray] = None,
    adaptive: bool = False,
):
    """Time loop of runLanczos.m:66-131: psi <- Q expm(-i dt T) e1 ||psi||
    per step.  method in {"lanczos", "ca"}.  Returns the final psi."""
    psi = jnp.asarray(psi0)
    if not jnp.iscomplexobj(psi):
        psi = psi.astype(jnp.complex128)

    if method == "ca" and basis == Basis.NEWTON and eigest is None:
        boot = lanczos(H, psi, 2 * s, Orth.LOCAL)
        eigest = np.linalg.eigvalsh(boot.T)

    for _ in range(n_steps):
        nrm = float(jnp.linalg.norm(psi))
        if method == "lanczos":
            res = lanczos_prop(H, psi, krylov_dim, dt, tol, adaptive)
        elif method == "ca":
            res = ca_lanczos_prop(
                H, psi, s, krylov_dim // s, dt, tol, basis, eigest, adaptive
            )
        else:
            raise ValueError(f"unknown method {method}")
        psi = res.apply_exp(dt, nrm)
    return psi


# ---------------------------------------------------------------------------
# Real/imag-split path: complex wavefunction as an (n, 2) real multivector.
#
# These paths run the whole Krylov recurrence in real arithmetic (for
# backends or kernels without complex support): the Hamiltonian is real
# symmetric, so
# spmv(H, psi_ri) on the stacked [re, im] columns IS the complex SpMV, and
# the Lanczos coefficients are real.  Only the final exp(-i dt T) e1
# coefficients are complex — applied as a 2x2 real rotation per column.
# ---------------------------------------------------------------------------


def _to_split(psi) -> jax.Array:
    """(n,) complex -> (n, 2) real [re, im]."""
    psi = jnp.asarray(psi)
    if psi.ndim == 2:
        return psi
    return jnp.stack([jnp.real(psi), jnp.imag(psi)], axis=1)


def _from_split(psi_ri: jax.Array) -> np.ndarray:
    p = np.asarray(psi_ri)
    return p[:, 0] + 1j * p[:, 1]


@jax.jit
def _prop_step_split(H: Operator, qj: jax.Array, qjm1: jax.Array, beta_prev: jax.Array):
    """One Lanczos step on the (n, 2) split representation: alpha =
    Re <q, r> = sum(q_re r_re + q_im r_im); the Im part vanishes for
    Hermitian H and is dropped (it is roundoff noise)."""
    r = spmv(H, qj) - beta_prev * qjm1
    alpha = jnp.sum(qj * r)
    r = r - alpha * qj
    beta = jnp.sqrt(jnp.sum(r * r))
    return r / beta, alpha, beta


@dataclasses.dataclass
class SplitPropResult:
    """Krylov factorization with the basis in split (n, 2, m) layout."""

    T: np.ndarray
    Q: jax.Array  # (n, 2, m)
    n_steps: int
    residual: float

    def apply_exp(self, dt: float, nrm: float) -> jax.Array:
        """psi(t+dt) in (n, 2) split layout."""
        m = self.T.shape[0]
        E = _expm_tridiag(self.T, dt)
        c = E[:m, 0] * nrm
        cr = jnp.asarray(np.real(c), self.Q.dtype)
        ci = jnp.asarray(np.imag(c), self.Q.dtype)
        Qre, Qim = self.Q[:, 0, :], self.Q[:, 1, :]
        out_re = mm(Qre, cr) - mm(Qim, ci)
        out_im = mm(Qre, ci) + mm(Qim, cr)
        return jnp.stack([out_re, out_im], axis=1)


def lanczos_prop_split(
    H: Operator,
    r0,
    maxiter: int,
    dt: float,
    tol: float = 1.0e-10,
    adaptive: bool = False,
) -> SplitPropResult:
    """lanczos_prop on the split representation — numerically identical
    to the complex path for real symmetric H (lanczos_prop.m:15-61), but
    runs entirely in real arithmetic."""
    psi = _to_split(r0)
    n = psi.shape[0]
    nrm = float(jnp.sqrt(jnp.sum(psi * psi)))
    q = psi / nrm

    Q = jnp.zeros((n, 2, maxiter + 1), q.dtype).at[:, :, 0].set(q)
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)
    residual = np.inf
    j = 0
    for j in range(1, maxiter + 1):
        qj = Q[:, :, j - 1]
        qjm1 = Q[:, :, j - 2] if j > 1 else jnp.zeros_like(qj)
        bprev = jnp.asarray(beta[j - 2] if j > 1 else 0.0, q.dtype)
        qn, a, b = _prop_step_split(H, qj, qjm1, bprev)
        alpha[j - 1] = float(a)
        beta[j - 1] = float(b)
        Q = Q.at[:, :, j].set(qn)
        if j >= 3:
            T = _tridiag(alpha[:j], beta[:j])
            E = _expm_tridiag(T, dt)
            residual = abs(dt * beta[j - 1] * E[j - 1, 0] * nrm)
            if residual < tol and adaptive:
                break

    T = _tridiag(alpha[:j], beta[:j])
    return SplitPropResult(T=T, Q=Q[:, :, :j], n_steps=j, residual=float(residual))


def propagate_split(
    H: Operator,
    psi0,
    dt: float,
    n_steps: int,
    krylov_dim: int = 24,
    tol: float = 1.0e-10,
    adaptive: bool = False,
) -> np.ndarray:
    """Split-representation time loop; returns the final complex psi."""
    psi = _to_split(psi0)
    for _ in range(n_steps):
        nrm = float(jnp.sqrt(jnp.sum(psi * psi)))
        res = lanczos_prop_split(H, psi, krylov_dim, dt, tol, adaptive)
        psi = res.apply_exp(dt, nrm)
    return _from_split(psi)


@jax.jit
def _split_powers(H: Operator, q: jax.Array, diag: jax.Array, sub: jax.Array) -> jax.Array:
    """Matrix powers of a split vector q (n, 2): the real Hamiltonian acts
    on re/im columns independently, so one multivector recurrence covers
    the complex chain.  Returns (n, 2, s+1)."""
    s = diag.shape[0]

    def step(carry, coeffs):
        v_km1, v_k = carry
        d, sb = coeffs
        w = spmv(H, v_k) - d * v_k - sb * v_km1
        return (v_k, w), w

    from jax import lax

    zero = jnp.zeros_like(q)
    _, ws = lax.scan(step, (zero, q), (diag, sub))
    return jnp.concatenate([q[None], ws], axis=0).transpose(1, 2, 0)


def ca_lanczos_prop_split(
    A: Operator,
    r0,
    s: int,
    m: int,
    dt: float,
    tol: float = 1.0e-10,
    basis: Basis = Basis.NEWTON,
    eigest: Optional[np.ndarray] = None,
    adaptive: bool = False,
) -> SplitPropResult:
    """ca_lanczos_prop on the real/imag-split representation.

    Identical block structure (ca_lanczos_prop.m:49-129) with the block
    orthogonalization decomposed into real Gram/update kernels
    (ops.csplit); the Newton shifts are real (nonmodified Leja of the
    real Ritz estimates, ca_lanczos_prop.m:40), so the recurrence
    coefficients stay real.
    """
    from ca_lanczos_tpu.ops.csplit import split_cholqr, split_project
    from ca_lanczos_tpu.solvers.propagators import _to_split

    basis = Basis(basis)
    psi = _to_split(r0)
    n = psi.shape[0]
    nrm = float(jnp.sqrt(jnp.sum(psi * psi)))
    q = psi / nrm
    dtype = q.dtype

    if basis == Basis.MONOMIAL:
        Bk = monomial_basis_matrix(s)
    else:
        if eigest is None:
            boot = lanczos(A, q[:, 0] + 0.0, 2 * s, Orth.LOCAL)
            basis_eigs = np.linalg.eigvalsh(boot.T)
        else:
            basis_eigs = np.asarray(eigest)
        shifts = leja(np.real(basis_eigs), LejaVariant.NONMODIFIED)
        Bk = newton_basis_matrix(shifts, s, modified=False)
    diag_np = np.real(np.diagonal(Bk))[:s].copy()
    sub_np = np.zeros(s)
    if s > 1:
        sub_np[1:] = np.real(np.diagonal(Bk, 1))[: s - 1]
    diag = jnp.asarray(diag_np, dtype)
    sub = jnp.asarray(sub_np, dtype)

    blocks: List[jax.Array] = []  # each (n, 2, s+1)
    b = np.zeros(m)
    T: Optional[np.ndarray] = None
    residual = np.inf
    k = 0

    while k < m:
        k += 1
        if k > 1:
            q = blocks[-1][:, :, s]

        V = _split_powers(A, q, diag, sub)

        if k == 1:
            Qb, Rk = split_cholqr(V)
            blocks.append(Qb)
            T, b[0] = first_block_T(Rk, Bk, s)
        else:
            Y, Rkk = split_project(blocks[-1], V[:, :, 1 : s + 1], passes=1)
            Qn, R = split_cholqr(Y)
            Tk, b[k - 1], _ = block_T(Rkk, R, Bk, b[k - 2], s)
            T = extend_T(T, Tk, b[k - 2], b[k - 1], s)
            blocks.append(
                jnp.concatenate([blocks[-1][:, :, s : s + 1], Qn], axis=2)
            )

        Tsq = np.real(T[: k * s, : k * s])
        E = _expm_tridiag(Tsq, dt)
        residual = abs(dt * b[k - 1] * E[k * s - 1, 0] * nrm)
        if residual < tol and k * s >= 3 and adaptive:
            break

    cols = [blocks[0]]
    for Bq in blocks[1:]:
        cols.append(Bq[:, :, 1 : s + 1])
    Q = jnp.concatenate(cols, axis=2)[:, :, : k * s]
    return SplitPropResult(
        T=np.real(T[: k * s, : k * s]), Q=Q, n_steps=k * s, residual=float(residual)
    )


@partial(jax.jit, static_argnames=("krylov_dim", "n_steps"))
def _propagate_split_fused(H: Operator, psi0: jax.Array, dt, krylov_dim: int, n_steps: int):
    """The whole propagation loop as ONE XLA program.

    Per time step: a fixed-krylov_dim split Lanczos recurrence
    (lax.scan), on-device eigh of the small tridiagonal T, and the
    exp(-i dt T) e1 application as real cos/sin rotations — no complex
    dtype, no host synchronization anywhere in the loop.  Adaptive early
    stopping is deliberately dropped (fixed shapes); use lanczos_prop /
    lanczos_prop_split when the reference's adaptive residual control is
    needed.
    """
    m = krylov_dim

    def time_step(psi, _):
        nrm = jnp.sqrt(jnp.sum(psi * psi))
        q0 = psi / nrm

        def lanczos_step(carry, _):
            q_prev, q, b_prev = carry
            r = spmv(H, q) - b_prev * q_prev
            a = jnp.sum(q * r)
            r = r - a * q
            b = jnp.sqrt(jnp.sum(r * r))
            # b is ||r||, so r/b is always unit — the only hazard is an
            # exact (underflowed) zero at happy breakdown; a zero vector
            # then propagates harmlessly (T decouples, e1 coupling 0).
            q_next = jnp.where(b > 0, r / jnp.where(b > 0, b, 1.0), 0.0)
            return (q, q_next, b), (a, b)

        zero = jnp.zeros_like(q0)
        _, (alpha, beta) = lax.scan(
            lanczos_step, (zero, q0, jnp.asarray(0.0, psi.dtype)), None, length=m
        )
        T = (
            jnp.diag(alpha)
            + jnp.diag(beta[: m - 1], 1)
            + jnp.diag(beta[: m - 1], -1)
        )
        d, V = jnp.linalg.eigh(T)
        # c = V exp(-i dt d) V^T e1 * nrm, via real cos/sin parts.
        ve1 = V[0, :] * nrm
        cr = mm(V, jnp.cos(dt * d) * ve1)
        ci = mm(V, -jnp.sin(dt * d) * ve1)

        # psi_new = sum_j Q[:, j] * (cr[j] + i ci[j]) in split form; rebuild
        # the basis by re-running the recurrence (trades flops for the
        # O(n*m) memory of storing Q — n*m*8B can exceed device memory
        # for large n).
        def accum_step(carry, coeffs):
            q_prev, q, b_prev, acc = carry
            a_j, b_j, crj, cij = coeffs
            acc = acc + jnp.stack([q[:, 0] * crj - q[:, 1] * cij,
                                   q[:, 0] * cij + q[:, 1] * crj], axis=1)
            r = spmv(H, q) - b_prev * q_prev
            r = r - a_j * q
            q_next = jnp.where(b_j > 0, r / jnp.where(b_j > 0, b_j, 1.0), 0.0)
            return (q, q_next, b_j, acc), None

        # psi is (n, 2) split throughout.
        q0_split = psi / nrm
        zero2 = jnp.zeros_like(q0_split)
        acc0 = jnp.zeros_like(q0_split)
        (_, _, _, acc), _ = lax.scan(
            accum_step,
            (zero2, q0_split, jnp.asarray(1.0, psi.dtype), acc0),
            (alpha, beta, cr, ci),
        )
        return acc, None

    psi, _ = lax.scan(time_step, psi0, None, length=n_steps)
    return psi




@partial(jax.jit, static_argnames=("krylov_dim", "n_steps"))
def _propagate_split_fused_adaptive(
    H: Operator, psi0: jax.Array, dt, krylov_dim: int, n_steps: int, tol
):
    """One-XLA-call propagation WITH the reference's adaptive residual
    control on device (lanczos_prop.m:44-55, VERDICT round-1 item 10).

    The per-time-step Lanczos runs as a fixed-shape ``lax.while_loop``
    that exits as soon as the Krylov residual
    |dt * beta_j * [exp(-i dt T_j)]_{j,1}| * |psi| drops below tol.  The
    growing T_j lives masked inside a fixed (m, m) array whose padding
    block is decoupled zeros: its spurious eigenpairs have zero weight in
    both the residual row and the e1 column, so the on-device eigh of the
    padded matrix reproduces eig(T_j) exactly where it matters.  The
    basis-rebuild accumulation pass is a second while_loop over only the
    j_used steps, so early convergence saves its SpMVs too.

    Returns (psi_final (n, 2), total_krylov_steps).
    """
    m = krylov_dim
    idx = jnp.arange(m)

    def time_step(carry, _):
        psi, steps_acc = carry
        nrm = jnp.sqrt(jnp.sum(psi * psi))
        q0 = psi / nrm

        def residual_of(alpha, beta, jj, b_last):
            amask = jnp.where(idx < jj, alpha, 0.0)
            bmask = jnp.where(idx[: m - 1] < jj - 1, beta[: m - 1], 0.0)
            T = jnp.diag(amask) + jnp.diag(bmask, 1) + jnp.diag(bmask, -1)
            d, V = jnp.linalg.eigh(T)
            vrow = V[jj - 1, :]
            er = jnp.sum(vrow * jnp.cos(dt * d) * V[0, :])
            ei = jnp.sum(vrow * jnp.sin(dt * d) * V[0, :])
            return jnp.abs(dt) * b_last * jnp.sqrt(er**2 + ei**2) * nrm

        def cond(c):
            _, _, _, _, _, j, done = c
            return (j < m) & ~done

        def body(c):
            q_prev, q, b_prev, alpha, beta, j, done = c
            r = spmv(H, q) - b_prev * q_prev
            a = jnp.sum(q * r)
            r = r - a * q
            b = jnp.sqrt(jnp.sum(r * r))
            alpha = alpha.at[j].set(a)
            beta = beta.at[j].set(b)
            q_next = jnp.where(b > 0, r / jnp.where(b > 0, b, 1.0), 0.0)
            res = residual_of(alpha, beta, j + 1, b)
            done = (j + 1 >= 3) & (res < tol)
            return (q, q_next, b, alpha, beta, j + 1, done)

        zero2 = jnp.zeros_like(q0)
        q_prev, q, b_prev, alpha, beta, j_used, _ = lax.while_loop(
            cond,
            body,
            (
                zero2,
                q0,
                jnp.asarray(0.0, psi.dtype),
                jnp.zeros(m, psi.dtype),
                jnp.zeros(m, psi.dtype),
                jnp.asarray(0, jnp.int32),
                jnp.asarray(False),
            ),
        )

        # Weights c = V exp(-i dt d) V^T e1 * nrm from the final masked T;
        # padding eigenpairs carry zero e1 weight, so c_j = 0 for
        # j >= j_used automatically.
        amask = jnp.where(idx < j_used, alpha, 0.0)
        bmask = jnp.where(idx[: m - 1] < j_used - 1, beta[: m - 1], 0.0)
        T = jnp.diag(amask) + jnp.diag(bmask, 1) + jnp.diag(bmask, -1)
        d, V = jnp.linalg.eigh(T)
        ve1 = V[0, :] * nrm
        cr = mm(V, jnp.cos(dt * d) * ve1)
        ci = mm(V, -jnp.sin(dt * d) * ve1)

        def acc_cond(c):
            _, _, _, _, j = c
            return j < j_used

        def acc_body(c):
            q_prev, q, acc, b_prev, j = c
            acc = acc + jnp.stack(
                [q[:, 0] * cr[j] - q[:, 1] * ci[j],
                 q[:, 0] * ci[j] + q[:, 1] * cr[j]],
                axis=1,
            )
            r = spmv(H, q) - b_prev * q_prev
            r = r - alpha[j] * q
            b_j = beta[j]
            q_next = jnp.where(b_j > 0, r / jnp.where(b_j > 0, b_j, 1.0), 0.0)
            return (q, q_next, acc, b_j, j + 1)

        acc0 = jnp.zeros_like(q0)
        _, _, acc, _, _ = lax.while_loop(
            acc_cond,
            acc_body,
            (jnp.zeros_like(q0), q0, acc0, jnp.asarray(1.0, psi.dtype),
             jnp.asarray(0, jnp.int32)),
        )
        return (acc, steps_acc + j_used), None

    (psi, steps), _ = lax.scan(
        time_step, (psi0, jnp.asarray(0, jnp.int32)), None, length=n_steps
    )
    return psi, steps


def propagate_split_fused(
    H: Operator, psi0, dt: float, n_steps: int, krylov_dim: int = 24,
    adaptive: bool = False, tol: float = 1.0e-10,
) -> np.ndarray:
    """One-XLA-call propagation (see _propagate_split_fused); returns the
    final complex psi.  ``adaptive=True`` enables the on-device residual
    early exit (lanczos_prop.m:44-55): each time step stops its Krylov
    expansion at the first j with residual < tol, entirely inside the
    compiled program (fixed shapes, no host syncs)."""
    psi = _to_split(psi0)
    if adaptive:
        out, _ = _propagate_split_fused_adaptive(
            H, psi, jnp.asarray(dt, psi.dtype), krylov_dim, n_steps,
            jnp.asarray(tol, psi.dtype),
        )
    else:
        out = _propagate_split_fused(H, psi, jnp.asarray(dt, psi.dtype), krylov_dim, n_steps)
    return _from_split(out)


def propagate_split_fused_steps(
    H: Operator, psi0, dt: float, n_steps: int, krylov_dim: int = 24,
    tol: float = 1.0e-10,
):
    """Adaptive fused propagation returning (psi, total_krylov_steps) —
    the on-chip step count for parity checks against the host adaptive
    path."""
    psi = _to_split(psi0)
    out, steps = _propagate_split_fused_adaptive(
        H, psi, jnp.asarray(dt, psi.dtype), krylov_dim, n_steps,
        jnp.asarray(tol, psi.dtype),
    )
    return _from_split(out), int(steps)
