"""Full-orthogonalization Arnoldi extension (reference: arnoldi.m:3-44).

Extends an existing factorization A Q_k = Q_{k+1} H by CGS-orthogonalizing
each new A q_j against ALL previous basis vectors; the alternative inner
iteration for the implicitly-restarted driver (commented call sites at
impl_restarted_ca_lanczos.m:89,94).  The projection h = Q^H (A q) and the
update are device matmuls; H bookkeeping is host math.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.ops.spmv import Operator, spmv


from functools import partial


@partial(jax.jit, static_argnames=("reorth",))
def _arnoldi_step(A: Operator, Q: jax.Array, j: jax.Array, reorth: bool = False):
    """w = A q_j; h = Q[:, :j+1]^H w (masked); w -= Q h; g = ||w||.

    reorth=True adds a second CGS pass (h accumulates) — required when
    the basis spans nearly-converged directions (the IRL resume), where
    one classical pass loses orthogonality catastrophically."""
    w = spmv(A, Q[:, j])
    mask = (jnp.arange(Q.shape[1]) <= j).astype(Q.dtype)
    Qm = Q * mask[None, :]
    h = mm(Qm.conj().T, w)
    w = w - mm(Qm, h)
    if reorth:
        h2 = mm(Qm.conj().T, w)
        w = w - mm(Qm, h2)
        h = h + h2
    g = jnp.linalg.norm(w)
    return w / g, h, g


def arnoldi(
    A: Operator,
    q: jax.Array,
    maxvecs: int,
    Q: Optional[jax.Array] = None,
    H: Optional[np.ndarray] = None,
    prevvecs: int = 0,
    reorth: bool = False,
) -> Tuple[jax.Array, np.ndarray]:
    """Extend (Q, H) to ``maxvecs`` Arnoldi vectors (arnoldi.m:3-44).

    With prevvecs == 0 a fresh factorization is started from q.
    ``reorth`` selects two-pass CGS per step (see _arnoldi_step).
    Returns (Q (n, maxvecs+1), H ((maxvecs+1), maxvecs)) with
    A Q[:, :maxvecs] = Q H.
    """
    n = q.shape[0]
    dtype = q.dtype
    Qf = jnp.zeros((n, maxvecs + 1), dtype)
    h_dtype = np.complex128 if jnp.iscomplexobj(q) else np.float64
    Hf = np.zeros((maxvecs + 1, maxvecs), h_dtype)
    if prevvecs > 0:
        assert Q is not None and H is not None
        Qf = Qf.at[:, : prevvecs + 1].set(Q[:, : prevvecs + 1])
        Hf[: H.shape[0], : H.shape[1]] = H
    else:
        Qf = Qf.at[:, 0].set(q / jnp.linalg.norm(q))

    for j in range(prevvecs, maxvecs):
        qn, h, g = _arnoldi_step(A, Qf, jnp.asarray(j), reorth=reorth)
        Qf = Qf.at[:, j + 1].set(qn)
        Hf[: j + 1, j] = np.asarray(h[: j + 1]).astype(h_dtype)
        Hf[j + 1, j] = float(g)
    return Qf, Hf
