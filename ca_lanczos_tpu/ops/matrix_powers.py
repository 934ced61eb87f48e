"""Matrix-powers kernels: build [q, Aq, ..., A^s q] in one shot.

This is the hot kernel of communication-avoiding Lanczos: one invocation
produces the whole s-step Krylov block so that (in the distributed setting)
only one halo exchange is paid per s SpMVs, and (on a single device) XLA
fuses the shift updates into the SpMV.

Reference behavior being reproduced:
* monomial basis — sequential SpMV loop (matrix_powers_monomial.m:6-12);
* Newton basis   — V[:,k+1] = (A - lambda_k I) V[:,k]
  (matrix_powers_newton.m:25-29);
* modified Newton — for the negative-imaginary member of a conjugate
  shift pair, adds ``+ imag(lambda_k)^2 * V[:,k-1]``
  (matrix_powers_newton.m:30-47).

All variants are expressed as one generic three-term recurrence driven by
the change-of-basis matrix B (see basis/newton.py):  since A V_s = V_{s+1} B
with B[k+1,k] = 1, we have

    V[:,k+1] = A V[:,k] - B[k,k] V[:,k] - B[k-1,k] V[:,k-1].

The recurrence is a ``lax.scan`` so the whole block compiles to one fused
loop under jit.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ca_lanczos_tpu.config import Basis
from ca_lanczos_tpu.ops.spmv import Operator, spmv


@partial(jax.jit, static_argnames=("s",))
def matrix_powers_monomial(A: Operator, q: jax.Array, s: int) -> jax.Array:
    """Return V = [q, Aq, A^2 q, ..., A^s q] with shape (n, s+1).

    (The reference returns only the s products, matrix_powers_monomial.m:6;
    callers immediately prepend q (ca_lanczos.m:112-113) — we return the
    full block directly.)
    """

    def step(v, _):
        w = spmv(A, v)
        return w, w

    with jax.named_scope("matrix_powers_monomial"):
        _, ws = lax.scan(step, q, None, length=s)
    return jnp.concatenate([q[None, :], ws], axis=0).T


@partial(jax.jit, static_argnames=("s",))
def _newton_scan(A: Operator, q: jax.Array, s: int, diag: jax.Array, sub: jax.Array) -> jax.Array:
    """V[:,k+1] = A V[:,k] - diag[k] V[:,k] - sub[k] V[:,k-1], k = 0..s-1."""

    def step(carry, coeffs):
        v_km1, v_k = carry
        d, sb = coeffs
        w = spmv(A, v_k) - d * v_k - sb * v_km1
        return (v_k, w), w

    zero = jnp.zeros_like(q)
    with jax.named_scope("matrix_powers_newton"):
        _, ws = lax.scan(step, (zero, q), (diag[:s], sub[:s]))
    return jnp.concatenate([q[None, :], ws], axis=0).T


def matrix_powers_newton(
    A: Operator,
    q: jax.Array,
    s: int,
    shifts,
    modified: bool = False,
) -> jax.Array:
    """Newton-basis matrix powers (reference: matrix_powers_newton.m:15-54).

    shifts: length >= s shift values (complex allowed).  With
    ``modified=True`` conjugate-pair shifts use the real three-term
    recurrence (the +imag^2 correction), so the basis stays real for a
    real A.  Shift preprocessing happens on host; the device scan only
    sees two real/complex coefficient vectors.
    """
    shifts = np.asarray(shifts)[:s]
    if modified:
        diag = np.real(shifts)
        sub = np.zeros(s, dtype=np.float64)
        for k in range(s):
            im = np.imag(shifts[k])
            if im < 0:
                if k == 0:
                    raise ValueError(
                        "modified Newton: first shift has negative imaginary part"
                        " (matrix_powers_newton.m:36-39)"
                    )
                sub[k] = -(im ** 2)  # B[k-1,k] = -imag^2 => recurrence adds +imag^2 V[k-1]
        diag_j = jnp.asarray(diag, dtype=q.dtype)
        sub_j = jnp.asarray(sub, dtype=q.dtype)
    else:
        dt = jnp.result_type(q.dtype, shifts.dtype)
        q = q.astype(dt)
        diag_j = jnp.asarray(shifts, dtype=dt)
        sub_j = jnp.zeros(s, dtype=dt)
    return _newton_scan(A, q, s, diag_j, sub_j)


def matrix_powers_from_B(A: Operator, q: jax.Array, B: np.ndarray) -> jax.Array:
    """Matrix powers driven directly by a change-of-basis matrix B.

    B is (s+1, s) with unit subdiagonal (newton_basis_matrix.m:13-60);
    the monomial basis corresponds to B = [0; I] (ca_lanczos.m:63-65).
    """
    B = np.asarray(B)
    s = B.shape[1]
    # Real change-of-basis coefficients adopt the vector's storage dtype
    # (an f32 basis must stay f32 — silently promoting the whole Krylov
    # block to f64 would hide the storage precision); complex shifts
    # still promote as the propagator path requires.
    dt = q.dtype if not np.iscomplexobj(B) else jnp.result_type(q.dtype, B.dtype)
    q = q.astype(dt)
    diag = jnp.asarray(np.diagonal(B)[:s], dtype=dt)
    sup = np.zeros(s, dtype=B.dtype)
    if s > 1:
        sup[1:] = np.diagonal(B, 1)[: s - 1]
    sub = jnp.asarray(sup, dtype=dt)
    return _newton_scan(A, q, s, diag, sub)


def matrix_powers(A: Operator, q: jax.Array, s: int, Bk: Optional[np.ndarray], basis: Basis) -> jax.Array:
    """Driver-facing dispatcher (reference: ca_lanczos.m:110-118): every
    operator, dtype and basis runs the fused XLA scan."""
    if basis == Basis.MONOMIAL:
        return matrix_powers_monomial(A, q, s)
    elif basis == Basis.NEWTON:
        return matrix_powers_from_B(A, q, Bk)
    raise ValueError(f"unknown basis {basis}")
