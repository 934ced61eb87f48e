"""Standard symmetric Lanczos with four (re)orthogonalization strategies.

Reference: lanczos.m.  The three-term recurrence step is one jitted device
function; the host loop owns alpha/beta bookkeeping, the omega roundoff
recurrence (periodic mode), and Ritz monitoring (selective mode).

Orth modes (lanczos.m:26-31):
* local     — plain three-term recurrence;
* full      — each new vector is re-projected against all previous
              (lanczos.m:62-66,112-114; projection only, no renormalize);
* periodic  — omega-recurrence roundoff model, reorthogonalize the last 7
              vectors when max omega >= sqrt(eps) (lanczos.m:248-255);
* selective — monitor converged Ritz pairs via beta*|Vp[j,i]| <
              ||A|| sqrt(eps) and orthogonalize new vectors against them
              (lanczos.m:146-185).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.ops.precision import mm, vdot
from ca_lanczos_tpu.config import Orth
from ca_lanczos_tpu.ops.orth import project_and_normalize
from ca_lanczos_tpu.ops.spmv import Operator, normest, spmv
from ca_lanczos_tpu.utils.diagnostics import (
    OmegaRecurrence,
    orth_error_last,
    ritz_residual_norms,
)

_SQRT_EPS = float(np.sqrt(np.finfo(np.float64).eps))


@jax.jit
def _lanczos_step(A: Operator, qj: jax.Array, qjm1: jax.Array, beta_prev: jax.Array):
    """r = A q_j - beta_{j-1} q_{j-1}; alpha = <q_j, r>; r -= alpha q_j.

    (lanczos.m:103-110.)"""
    r = spmv(A, qj) - beta_prev * qjm1
    alpha = vdot(qj, r)
    r = r - alpha * qj
    beta = jnp.linalg.norm(r)
    return r / beta, alpha, beta


@jax.jit
def _project_all_masked(Q: jax.Array, q: jax.Array, j: jax.Array) -> jax.Array:
    """Project q against the first j columns of Q (fixed shapes: columns
    >= j are masked).  Full-orth pass of lanczos.m:62-66 — projection
    only, no renormalization, matching the reference."""
    mask = (jnp.arange(Q.shape[1]) < j).astype(Q.dtype)
    Qm = Q * mask[None, :]
    return q - mm(Qm, mm(Qm.conj().T, q))


@dataclasses.dataclass
class LanczosResult:
    """T is the m x m tridiagonal; beta[m-1] is the next off-diagonal
    (the residual norm of the last step), needed by restarted drivers."""

    T: np.ndarray
    Q: jax.Array
    alpha: np.ndarray
    beta: np.ndarray
    ritz_rnorm: Optional[np.ndarray] = None
    orth_err: Optional[np.ndarray] = None
    n_reorth: int = 0

    @property
    def T_ext(self) -> np.ndarray:
        """(m+1) x m extended tridiagonal including the trailing beta row."""
        m = self.T.shape[0]
        out = np.zeros((m + 1, m))
        out[:m] = self.T
        out[m, m - 1] = self.beta[m - 1]
        return out


def _tridiag(alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    m = len(alpha)
    T = np.diag(alpha)
    if m > 1:
        T += np.diag(beta[: m - 1], 1) + np.diag(beta[: m - 1], -1)
    return T


def lanczos(
    A: Operator,
    r: jax.Array,
    maxiter: int,
    orth: Orth = Orth.LOCAL,
    diagnostics: bool = False,
) -> LanczosResult:
    """Symmetric Lanczos (lanczos.m:18-60)."""
    orth = Orth(orth)
    n = r.shape[0]
    q = r / jnp.linalg.norm(r)
    dtype = q.dtype

    Q = jnp.zeros((n, maxiter + 1), dtype).at[:, 0].set(q)
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)

    rnorm_hist = [] if diagnostics else None
    orth_hist = [] if diagnostics else None
    n_reorth = 0

    omega = OmegaRecurrence(normest(A)) if orth == Orth.PERIODIC else None
    norm_sqrt_eps = normest(A) * _SQRT_EPS if orth == Orth.SELECTIVE else None
    QR: Optional[jax.Array] = None  # converged Ritz basis (selective)
    nritz = 0

    for j in range(1, maxiter + 1):
        qj = Q[:, j - 1]
        qjm1 = Q[:, j - 2] if j > 1 else jnp.zeros_like(qj)
        bprev = jnp.asarray(beta[j - 2] if j > 1 else 0.0, dtype)
        qnext, a_j, b_j = _lanczos_step(A, qj, qjm1, bprev)
        alpha[j - 1] = float(np.real(np.asarray(a_j)))
        beta[j - 1] = float(np.asarray(b_j))
        Q = Q.at[:, j].set(qnext)

        if orth == Orth.FULL:
            # Re-project the new vector on all previous (lanczos.m:112-114).
            Q = Q.at[:, j].set(_project_all_masked(Q, Q[:, j], j))

        elif orth == Orth.SELECTIVE:
            # Track converged Ritz pairs and orthogonalize against them
            # (lanczos.m:164-185).
            T = _tridiag(alpha[:j], beta[:j])
            d, Vp = np.linalg.eigh(T)
            conv = [i for i in range(j) if beta[i] * abs(Vp[j - 1, i]) < norm_sqrt_eps]
            if len(conv) > nritz:
                n_reorth += 1
                nritz = len(conv)
                Vc = jnp.asarray(Vp[:, conv], dtype)
                QR = mm(Q[:, :j], Vc)
            if nritz > 0 and QR is not None:
                res = project_and_normalize([QR], Q[:, j], reorth=False)
                Q = Q.at[:, j].set(res.Q)

        elif orth == Orth.PERIODIC:
            # omega roundoff recurrence (lanczos.m:248-255).
            omega.update(alpha[:j], beta[:j])
            if j > 1 and omega.max_error_scalar() >= _SQRT_EPS:
                n_reorth += 1
                lo = max(0, j - 6)
                block = Q[:, lo : j + 1]
                prev = Q[:, :lo]
                res = project_and_normalize([prev] if lo > 0 else [], block, reorth=True)
                Q = Q.at[:, lo : j + 1].set(res.Q)
                omega.reset_scalar()

        if diagnostics:
            T = _tridiag(alpha[:j], beta[:j])
            d, Vp = np.linalg.eigh(T)
            row = np.zeros(maxiter)
            row[:j] = ritz_residual_norms(A, Q[:, :j], Vp, d)
            rnorm_hist.append(row)
            orth_hist.append(orth_error_last(Q[:, : j + 1]))

    T = _tridiag(alpha, beta)
    return LanczosResult(
        T=T,
        Q=Q[:, :maxiter],
        alpha=alpha,
        beta=beta,
        ritz_rnorm=np.asarray(rnorm_hist) if diagnostics else None,
        orth_err=np.asarray(orth_hist) if diagnostics else None,
        n_reorth=n_reorth,
    )
