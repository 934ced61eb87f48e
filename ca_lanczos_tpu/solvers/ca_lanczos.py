"""Communication-avoiding Lanczos (Hoemmen-style), reference ca_lanczos.m.

Per outer iteration: one matrix-powers block of s SpMVs (the only step
that would cross device halos when distributed), one block
orthogonalization against the previous s+1 basis columns (tall-skinny
GEMMs + TSQR), and O(s^2) host math recovering the tridiagonal block from
the R factors.

Orth modes (ca_lanczos.m:74-81):
* local     — orthogonalize each block against the previous block only;
* full      — local pass (R factors feed Tk), then a second
              projectAndNormalize against the whole basis
              (ca_lanczos.m:191-197);
* periodic  — blocked omega recurrence; when max omega >= sqrt(eps),
              reorthogonalize the current s+1 columns against all previous
              (ca_lanczos.m:430-446);
* selective — track converged Ritz vectors, orthogonalize each new block
              against them (ca_lanczos.m:248-359).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.basis.leja import leja
from ca_lanczos_tpu.basis.newton import newton_basis_matrix
from ca_lanczos_tpu.config import Basis, LejaVariant, Orth, OrthParams
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers
from ca_lanczos_tpu.ops.orth import normalize, project_and_normalize
from ca_lanczos_tpu.ops.spmv import Operator, normest
from ca_lanczos_tpu.solvers._block import block_T, extend_T, first_block_T
from ca_lanczos_tpu.solvers.lanczos import lanczos
from ca_lanczos_tpu.utils.diagnostics import (
    OmegaRecurrence,
    orth_error_block,
    ritz_residual_norms,
)

_SQRT_EPS = float(np.sqrt(np.finfo(np.float64).eps))


def monomial_basis_matrix(s: int) -> np.ndarray:
    """Bk for the monomial basis: I(s+1)[:, 1:] (ca_lanczos.m:63-65)."""
    return np.eye(s + 1)[:, 1:]


def newton_shifts_bootstrap(
    A: Operator,
    q: jax.Array,
    s: int,
    orth: Orth = Orth.FULL,
    leja_variant: LejaVariant = LejaVariant.REAL,
) -> np.ndarray:
    """Run 2s steps of standard Lanczos, Leja-order eig(T) and build Bk
    (ca_lanczos.m:66-72).

    The reference's ``leja(eigs,'nonmodified')`` call actually executes
    the real/modified path (leja.m:23-31 quirk), so the default variant
    here is REAL.
    """
    boot = lanczos(A, q, 2 * s, orth)
    basis_eigs = np.linalg.eigvalsh(boot.T)
    shifts = leja(basis_eigs, leja_variant)
    return newton_basis_matrix(shifts, s, modified=True)


def build_basis_matrix(
    A: Operator,
    q: jax.Array,
    s: int,
    basis: Basis,
    bootstrap_orth: Orth = Orth.FULL,
) -> np.ndarray:
    basis = Basis(basis)
    if basis == Basis.MONOMIAL:
        return monomial_basis_matrix(s)
    return newton_shifts_bootstrap(A, q, s, bootstrap_orth)


@dataclasses.dataclass
class CaLanczosResult:
    T: np.ndarray  # (s*t, s*t) projection matrix
    Q: jax.Array  # (n, s*t) basis
    Bk: np.ndarray
    beta: np.ndarray  # per-block betas; beta[t-1] is the trailing one
    ritz_rnorm: Optional[np.ndarray] = None
    orth_err: Optional[np.ndarray] = None
    n_reorth: int = 0

    @property
    def T_ext(self) -> np.ndarray:
        m = self.T.shape[0]
        out = np.zeros((m + 1, m))
        out[:m] = self.T
        out[m, m - 1] = self.beta[-1]
        return out


def ca_lanczos(
    A: Operator,
    r: jax.Array,
    s: int,
    total_steps: int,
    basis: Basis = Basis.MONOMIAL,
    orth: Orth = Orth.LOCAL,
    diagnostics: bool = False,
    params: OrthParams = OrthParams(),
    Bk: Optional[np.ndarray] = None,
) -> CaLanczosResult:
    """CA-Lanczos driver (ca_lanczos.m:24-86).

    total_steps is the Krylov dimension; t = ceil(total_steps / s) outer
    iterations are performed (ca_lanczos.m:52).
    """
    orth = Orth(orth)
    basis = Basis(basis)
    t = int(np.ceil(total_steps / s))

    q = r / jnp.linalg.norm(r)
    if Bk is None:
        Bk = build_basis_matrix(A, q, s, basis)

    n = q.shape[0]
    dtype = q.dtype
    Q = jnp.zeros((n, t * s + 1), dtype)
    b = np.zeros(t)
    T: Optional[np.ndarray] = None

    rnorm_hist: List[np.ndarray] = []
    orth_hist: List[float] = []
    n_reorth = 0

    omega = OmegaRecurrence(normest(A)) if orth == Orth.PERIODIC else None
    norm_sqrt_eps = normest(A) * _SQRT_EPS if orth == Orth.SELECTIVE else None
    QR: Optional[jax.Array] = None
    nritz = 0

    for k in range(1, t + 1):
        q = Q[:, (k - 1) * s] if k > 1 else q
        V = matrix_powers(A, q, s, Bk, basis)

        if k == 1:
            Qb, Rk, _ = normalize(V, params=params)
            Q = Q.at[:, : s + 1].set(Qb)
            T, b[0] = first_block_T(Rk, Bk, s)
        else:
            prev = Q[:, (k - 2) * s : (k - 1) * s + 1]
            blocks = [prev]
            if orth == Orth.SELECTIVE and nritz > 0 and QR is not None:
                blocks.append(QR)
            res = project_and_normalize(blocks, V[:, 1 : s + 1], reorth=True, params=params)
            Q = Q.at[:, (k - 1) * s + 1 : k * s + 1].set(res.Q[:, :s])
            Rkk_s = res.R_blocks[0]
            Rk_s = res.R

            if orth == Orth.FULL:
                # Extra full pass against the whole previous basis
                # (ca_lanczos.m:196-197); R factors are not reused.
                allprev = Q[:, : (k - 1) * s + 1]
                res2 = project_and_normalize(
                    [allprev], Q[:, (k - 1) * s + 1 : k * s + 1], reorth=True, params=params
                )
                Q = Q.at[:, (k - 1) * s + 1 : k * s + 1].set(res2.Q)

            Tk, b[k - 1], _ = block_T(Rkk_s, Rk_s, Bk, b[k - 2], s)
            T = extend_T(T, Tk, b[k - 2], b[k - 1], s)

        if orth == Orth.SELECTIVE:
            # Converged-Ritz tracking (ca_lanczos.m:317-336).
            Tsq = T[: s * k, : s * k]
            d, Vp = np.linalg.eigh(Tsq)
            conv = [i for i in range(s * k) if b[k - 1] * abs(Vp[s * k - 1, i]) < norm_sqrt_eps]
            if len(conv) > nritz:
                n_reorth += 1
                nritz = len(conv)
                Vc = jnp.asarray(Vp[:, conv], dtype)
                QR_raw = mm(Q[:, : s * k], Vc)
                QR, _, _ = normalize(QR_raw, params=params)

        elif orth == Orth.PERIODIC:
            # Blocked omega recurrence (ca_lanczos.m:430-446).
            alpha = np.diagonal(T[: s * k, : s * k]).copy()
            beta_sub = np.diagonal(T[: s * k + 1, : s * k], -1).copy()
            omega.update(alpha, beta_sub)
            if k > 1 and omega.max_error_block(s) >= _SQRT_EPS:
                n_reorth += 1
                lo = (k - 1) * s
                block = Q[:, lo : k * s + 1]
                res = project_and_normalize([Q[:, :lo]], block, reorth=True, params=params)
                Q = Q.at[:, lo : k * s + 1].set(res.Q)
                omega.reset_block(s)

        if diagnostics:
            Tsq = T[: s * k, : s * k]
            d, Vp = np.linalg.eigh(Tsq)
            row = np.zeros(t * s)
            row[: s * k] = ritz_residual_norms(A, Q[:, : s * k], Vp, d)
            rnorm_hist.append(row)
            orth_hist.append(orth_error_block(Q[:, : s * k + 1], s))

    return CaLanczosResult(
        T=T[: s * t, : s * t],
        Q=Q[:, : s * t],
        Bk=Bk,
        beta=b,
        ritz_rnorm=np.asarray(rnorm_hist) if diagnostics else None,
        orth_err=np.asarray(orth_hist) if diagnostics else None,
        n_reorth=n_reorth,
    )
