"""Convergence and orthogonality diagnostics.

The reference computes these *inside* the drivers and returns them
(lanczos.m:68-83, ca_lanczos.m:88-107); here they are one shared module.
Heavy pieces (Ritz residuals, Gram products) are device ops; the omega
roundoff recurrence (Simon's estimate) is O((st)^2) host math.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.ops.spmv import Operator


@jax.jit
def _ritz_rnorm_jit(A: Operator, Q: jax.Array, Vp: jax.Array, d: jax.Array) -> jax.Array:
    X = mm(Q, Vp)  # Ritz vectors (n, m)
    AX = A.matvec(X)
    num = jnp.linalg.norm(AX - X * d[None, :], axis=0)
    den = jnp.abs(d) * jnp.linalg.norm(X, axis=0)
    return num / den


def ritz_residual_norms(A: Operator, Q, Vp, d) -> np.ndarray:
    """Relative Ritz residuals ||A x - l x|| / ||l x||, in descending-
    eigenvalue order (lanczos.m:68-77, ca_lanczos.m:88-97)."""
    d = np.asarray(d)
    order = np.argsort(d)[::-1]
    Vp_j = jnp.asarray(np.asarray(Vp)[:, order], dtype=Q.dtype)
    d_j = jnp.asarray(d[order], dtype=Q.dtype)
    return np.asarray(_ritz_rnorm_jit(A, Q, Vp_j, d_j))


def orth_error_fro(Q) -> float:
    """||I - Q^H Q||_F (restarted_ca_lanczos.m:166-167)."""
    Q = jnp.asarray(Q)
    m = Q.shape[1]
    G = mm(Q.conj().T, Q)
    return float(jnp.linalg.norm(G - jnp.eye(m, dtype=G.dtype)))


def orth_error_last(Q) -> float:
    """max(Q[:, :j-1]^H Q[:, j]) for the newest vector (lanczos.m:79-83).

    Note: the reference takes the (signed) max, not max-abs; preserved.
    """
    Q = jnp.asarray(Q)
    j = Q.shape[1]
    if j < 2:
        return 0.0
    return float(jnp.max(jnp.real(mm(Q[:, : j - 1].conj().T, Q[:, j - 1]))))


def orth_error_block(Q, s: int) -> float:
    """Block orthogonality error (ca_lanczos.m:99-107): max |Q_old^H Q_new|
    between all-but-last-block and the last s+1 columns."""
    Q = jnp.asarray(Q)
    j = Q.shape[1]
    if j > s + 1:
        G = mm(Q[:, : j - s - 1].conj().T, Q[:, j - s - 1 :])
        return float(jnp.max(jnp.abs(G)))
    G = mm(Q.conj().T, Q)
    return float(jnp.max(jnp.abs(G - jnp.eye(j, dtype=G.dtype))))


class OmegaRecurrence:
    """Simon's omega-recurrence estimate of orthogonality loss.

    One implementation serves both the scalar form (one new row per
    Lanczos step, lanczos.m:267-311) and the blocked form (s new rows per
    CA block, ca_lanczos.m:469-539): ``update`` extends the (m+1)x(m+1)
    estimate matrix until it covers len(alpha)+1 rows, given the full
    alpha (diag T) and beta (subdiag T, including the trailing block beta)
    histories.

    omega[j, k] estimates |q_j^T q_k| (1-indexed rows/cols in the math;
    stored 0-indexed).
    """

    def __init__(self, anorm: float, eps: Optional[float] = None):
        self.t = (np.finfo(np.float64).eps if eps is None else eps) * anorm
        self.omega: Optional[np.ndarray] = None

    def _seed(self, beta1: float) -> None:
        om = np.zeros((2, 2))
        om[0, 0] = 1.0
        om[0, 1] = 0.0
        om[1, 0] = self.t / beta1
        om[1, 1] = 1.0
        self.omega = om

    def update(self, alpha, beta) -> np.ndarray:
        """Extend to cover n = len(alpha) steps (n+1 rows)."""
        a = np.asarray(alpha, dtype=np.float64)
        b = np.asarray(beta, dtype=np.float64)
        n = len(a)
        T = self.t

        if self.omega is None:
            self._seed(b[0])
        m = self.omega.shape[0] - 1  # steps currently covered
        if n + 1 <= self.omega.shape[0]:
            return self.omega

        om = np.zeros((n + 1, n + 1))
        om[: m + 1, : m + 1] = self.omega

        # Extend rows j+1 for j = m+1 .. n (1-indexed step j).
        for j in range(m + 1, n + 1):
            binv = 1.0 / b[j - 1]
            # k = 1 (no omega[j, k-1] term).
            w = b[1] * om[j - 1, 1] + (a[0] - a[j - 1]) * om[j - 1, 0] - b[j - 1] * om[j - 2, 0]
            om[j, 0] = binv * (w + T) if w > 0 else binv * (w - T)
            # k = 2 .. j-1.
            for k in range(2, j):
                w = (
                    b[k] * om[j - 1, k]
                    + (a[k - 1] - a[j - 1]) * om[j - 1, k - 1]
                    + b[k - 1] * om[j - 1, k - 2]
                    - b[j - 1] * om[j - 2, k - 1]
                )
                om[j, k - 1] = binv * (w + T) if w > 0 else binv * (w - T)
            om[j, j - 1] = binv * T
            om[j, j] = 1.0

        self.omega = om
        return om

    def max_error_scalar(self) -> float:
        """Scalar-form trigger value: max |omega[n+1, 1:n]| (lanczos.m:250)."""
        om = self.omega
        n = om.shape[0] - 1
        return float(np.max(np.abs(om[n, :n]))) if n >= 1 else 0.0

    def max_error_block(self, s: int) -> float:
        """Blocked trigger (ca_lanczos.m:434-441): max over the last s rows
        i of max |omega[row, 1:row-1]|."""
        om = self.omega
        n = om.shape[0] - 1
        err = 0.0
        for i in range(s):
            row = n - s + 1 + i  # 1-indexed row (row+1 in MATLAB terms)
            err = max(err, float(np.max(np.abs(om[row, :row]))))
        return err

    def reset_scalar(self) -> None:
        """Scalar reset after reorthogonalization (lanczos.m:302-311)."""
        om = self.omega
        n = om.shape[0] - 1
        om[n - 1, :n] = self.t
        om[n, :n] = self.t
        om[n - 1, n - 1] = 1.0
        om[n - 1, n] = 0.0
        om[n, n] = 1.0

    def reset_block(self, s: int) -> None:
        """Blocked reset (ca_lanczos.m:541-551): last s rows set to T with
        unit diagonal."""
        om = self.omega
        m = om.shape[0] - s - 1
        for j in range(m + 1, m + s + 1):
            om[j, :j] = self.t
            om[j, j] = 1.0
