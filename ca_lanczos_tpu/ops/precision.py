"""Matmul precision of every device product in the solvers.

On an NVIDIA GPU a float32 matmul may run in TF32, which keeps about
three decimal digits.  The block orthogonalization (Gram, CholQR/CholQR2,
the TSQR R-combine, CGS projections), the Ritz-vector GEMVs and the
polish Rayleigh-Ritz feed the lock gate and the T recovery, which need
full float32 orthogonality, so every device product in the package asks
for ``HIGHEST`` through the helpers below.  This module is the one place
that choice is made; float64 products are unaffected by it.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

PRECISION = lax.Precision.HIGHEST


def mm(a, b):
    """``a @ b`` at full precision."""
    return jnp.matmul(a, b, precision=PRECISION)


def einsum(subscripts: str, *operands, **kwargs):
    """``jnp.einsum`` at full precision."""
    return jnp.einsum(subscripts, *operands, precision=PRECISION, **kwargs)


def vdot(a, b):
    """``jnp.vdot`` at full precision."""
    return jnp.vdot(a, b, precision=PRECISION)
