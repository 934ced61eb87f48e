"""Distributed Lanczos time propagation on the split representation.

The reference's propagation experiment (runLanczos.m:66-131) is built on
a periodic FD Hamiltonian (wrap entries, :15-18) that round 1 could not
distribute — the halo exchange fed edge shards zeros.  With the
ring-periodic halo (parallel.distributed._halo_exchange(periodic=True))
the wrap rides the same one-ppermute-per-step machinery, so the complex
wavefunction (as a real (n, 2) re/im multivector, solvers.propagators
split path) propagates row-sharded across the mesh:

* SpMV: halo exchange + local banded/ELL matvec on both columns;
* alpha/beta dot products: GSPMD global reductions over the sharded
  arrays (no explicit collectives needed);
* the small T exponential stays host math (lanczos_prop.m:44-50).
"""

from __future__ import annotations

from functools import partial
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec

from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.parallel.dist_ell import DistEll
from ca_lanczos_tpu.parallel.distributed import DistDia, _halo_exchange
from ca_lanczos_tpu.parallel.mesh import ROWS, row_axes, row_spec
from ca_lanczos_tpu.solvers.propagators import _expm_tridiag, _tridiag


def _dia_matvec_cols(offsets, data, x):
    """Banded matvec on an already-padded local (m, c) multivector."""
    m = data.shape[1]
    wl = max(0, -min(offsets)) if offsets else 0
    wr = max(0, max(offsets)) if offsets else 0
    xp = jnp.pad(x, ((wl, wr), (0, 0)))
    y = jnp.zeros_like(x)
    for d, k in enumerate(offsets):
        y = y + data[d][:, None] * lax.slice_in_dim(xp, wl + k, wl + k + m, axis=0)
    return y


@partial(jax.jit, static_argnames=("mesh",))
def dist_spmv_cols(A: Union[DistDia, DistEll], x: jax.Array, mesh: Mesh) -> jax.Array:
    """Distributed SpMV of a row-sharded (n_pad, c) multivector."""
    axes = row_axes(mesh)
    if isinstance(A, DistDia):
        def body(data_block, x_local):
            xp = _halo_exchange(x_local, A.halo, A.n_shards, A.periodic, axes)
            y = _dia_matvec_cols(A.offsets, data_block[0], xp)
            return y[A.halo : A.halo + x_local.shape[0]]

        operands = (A.data,)
    else:
        def body(v_block, c_block, x_local):
            xp = _halo_exchange(x_local, A.halo, A.n_shards, A.periodic, axes)
            vals, cols = v_block[0], c_block[0]
            y = jnp.sum(vals[..., None] * jnp.take(xp, cols, axis=0), axis=1)
            return y[A.halo : A.halo + x_local.shape[0]]

        operands = (A.vals, A.cols)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=tuple([row_spec(mesh)] * (len(operands) + 1)),
        out_specs=row_spec(mesh),
    )(*operands, x)


def dist_lanczos_prop_split(
    A, psi: jax.Array, maxiter: int, dt: float, mesh: Mesh, tol: float = 1.0e-10,
    adaptive: bool = False,
):
    """One Krylov propagation solve on the mesh (lanczos_prop.m:15-61 on
    the split representation).  psi: row-sharded (n_pad, 2), unnormalized.
    Returns (T (j, j), Q (n_pad, 2, j+1) sharded, nrm, j)."""
    nrm = float(jnp.sqrt(jnp.sum(psi * psi)))
    q = psi / nrm
    cols = [q]
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)
    j_used = maxiter
    for j in range(1, maxiter + 1):
        qj = cols[j - 1]
        w = dist_spmv_cols(A, qj, mesh)
        if j > 1:
            w = w - beta[j - 2] * cols[j - 2]
        a = float(jnp.sum(qj * w))  # GSPMD global dot
        w = w - a * qj
        b = float(jnp.sqrt(jnp.sum(w * w)))
        alpha[j - 1], beta[j - 1] = a, b
        cols.append(w / b)
        if adaptive and j >= 3:
            T = _tridiag(alpha[:j], beta[:j])
            E = _expm_tridiag(T, dt)
            residual = abs(dt * beta[j - 1] * E[j - 1, 0]) * nrm
            if residual < tol:
                j_used = j
                break
        j_used = j
    T = _tridiag(alpha[:j_used], beta[:j_used])
    Q = jnp.stack(cols[: j_used + 1], axis=2)
    return T, Q, nrm, j_used


def dist_propagate_split(
    A, psi0, dt: float, n_steps: int, mesh: Mesh, krylov_dim: int = 24,
    tol: float = 1.0e-10, adaptive: bool = False,
) -> np.ndarray:
    """Distributed runLanczos time loop; psi0 is a host complex (n,)
    vector; returns the final complex psi (n,) on host.

    A: DistDia or DistEll (build with periodic=True for the reference's
    wrap Hamiltonian, runLanczos.m:15-18)."""
    n = A.n
    psi0 = np.asarray(psi0)
    split = np.stack([np.real(psi0), np.imag(psi0)], axis=1)
    psi = A.shard_vector(split, mesh)

    for _ in range(n_steps):
        T, Q, nrm, j = dist_lanczos_prop_split(A, psi, krylov_dim, dt, mesh, tol, adaptive)
        E = _expm_tridiag(T, dt)  # complex (j, j)
        w = E[:, 0] * nrm  # complex weights on the Krylov basis
        wr = jnp.asarray(np.real(w))
        wi = jnp.asarray(np.imag(w))
        Qb = Q[:, :, : j]
        re = mm(Qb[:, 0, :], wr) - mm(Qb[:, 1, :], wi)
        im = mm(Qb[:, 0, :], wi) + mm(Qb[:, 1, :], wr)
        psi = jnp.stack([re, im], axis=1)

    host = np.asarray(psi)[:n]
    return host[:, 0] + 1j * host[:, 1]
