"""Complex linear algebra on the real/imag-split representation.

Complex (n,) vectors ride as (n, 2) real arrays [re, im]; complex (n, m)
multivectors as (n, 2, m).  Every device op below is pure real
arithmetic (for backends or kernels without complex lowering); the small
complex m x m factors live on host as numpy complex128.

Used by the split CA propagator (solvers.propagators.ca_lanczos_prop_split):
the reference's projectAndNormalize on complex Krylov blocks
(ca_lanczos_prop.m:67-86) decomposes into these Gram/update kernels.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.ops.precision import einsum, mm


def split_gram(Q: jax.Array, X: jax.Array) -> np.ndarray:
    """R = Q^H X for split multivectors Q (n,2,m), X (n,2,p) -> complex
    (m, p) on host.  Re R = Qre.Xre + Qim.Xim; Im R = Qre.Xim - Qim.Xre."""
    Rr = einsum("nci,ncj->ij", Q, X)
    Ri = einsum("ni,nj->ij", Q[:, 0, :], X[:, 1, :]) - einsum(
        "ni,nj->ij", Q[:, 1, :], X[:, 0, :]
    )
    return np.asarray(Rr, np.float64) + 1j * np.asarray(Ri, np.float64)


@jax.jit
def _split_apply(X: jax.Array, Q: jax.Array, Rr: jax.Array, Ri: jax.Array) -> jax.Array:
    """X - Q @ (Rr + i Ri) in split form."""
    Qre, Qim = Q[:, 0, :], Q[:, 1, :]
    Xre = X[:, 0, :] - (mm(Qre, Rr) - mm(Qim, Ri))
    Xim = X[:, 1, :] - (mm(Qre, Ri) + mm(Qim, Rr))
    return jnp.stack([Xre, Xim], axis=1)


def split_project(Q: jax.Array, X: jax.Array, passes: int = 1) -> Tuple[jax.Array, np.ndarray]:
    """Block CGS of split X against split-orthonormal Q; returns
    (Y, accumulated complex R)."""
    R = np.zeros((Q.shape[2], X.shape[2]), np.complex128)
    Y = X
    for _ in range(passes):
        Rp = split_gram(Q, Y)
        Y = _split_apply(Y, Q, jnp.asarray(Rp.real, X.dtype), jnp.asarray(Rp.imag, X.dtype))
        R = R + Rp
    return Y, R


@jax.jit
def _split_matmul(X: jax.Array, Mr: jax.Array, Mi: jax.Array) -> jax.Array:
    """X @ (Mr + i Mi) in split form."""
    Xre, Xim = X[:, 0, :], X[:, 1, :]
    return jnp.stack(
        [mm(Xre, Mr) - mm(Xim, Mi), mm(Xre, Mi) + mm(Xim, Mr)], axis=1
    )


def split_cholqr(X: jax.Array, passes: int = 2) -> Tuple[jax.Array, np.ndarray]:
    """Cholesky QR of a split multivector: G = X^H X (hermitian, host
    complex), R = chol(G), Q = X R^{-1}; ``passes`` iterations for
    orthogonality (CholQR2 default).  Returns (Q split, complex R)."""
    m = X.shape[2]
    R_acc = np.eye(m, dtype=np.complex128)
    Q = X
    for _ in range(passes):
        G = split_gram(Q, Q)
        G = (G + G.conj().T) / 2
        # Few-ulp shift like ops.qr._chol_safe.
        tr = float(np.real(np.trace(G)))
        eps = float(jnp.finfo(X.dtype).eps)
        try:
            L = np.linalg.cholesky(G)
        except np.linalg.LinAlgError:
            L = np.linalg.cholesky(G + 11 * (m + 1) * eps * tr * np.eye(m))
        R = L.conj().T
        Rinv = np.linalg.inv(R)
        Q = _split_matmul(Q, jnp.asarray(Rinv.real, X.dtype), jnp.asarray(Rinv.imag, X.dtype))
        R_acc = R @ R_acc
    return Q, R_acc
