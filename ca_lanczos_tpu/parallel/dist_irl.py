"""Distributed implicitly-restarted CA-Lanczos over a ('rows',) mesh.

The IRL driver (solvers.implicitly_restarted, reference
impl_restarted_ca_lanczos.m) with the n-sized state row-sharded:

* Krylov extension from k to m columns by distributed CA blocks
  (parallel.step.dist_ca_block: halo powers + psum CGS + dist QR);
* the exact-shift QR bulge chase stays host math on the m x m T;
* the basis compression V <- V Q[:, :k] and the residual update are
  dense sharded GEMMs — plain jnp over NamedSharding arrays, GSPMD
  partitions rows and no collective is needed (right-multiplication by a
  replicated small matrix is embarrassingly row-parallel).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ca_lanczos_tpu.config import Basis
from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.ops.spmv import normest
from ca_lanczos_tpu.parallel.mesh import ROWS, row_spec
from ca_lanczos_tpu.parallel.restarted import _dist_reorth
from ca_lanczos_tpu.parallel.step import (
    dist_ca_block,
    dist_first_block,
    newton_coeffs,
    partition_operator,
)
from ca_lanczos_tpu.parallel.restarted import _dist_spmv_any
from ca_lanczos_tpu.solvers._block import block_T, first_block_T
from ca_lanczos_tpu.solvers.ca_lanczos import build_basis_matrix, monomial_basis_matrix
from ca_lanczos_tpu.solvers.implicitly_restarted import IRLResult, qrstep


def _verify_ritz(Adist, V, Y, d, order, k, mesh, dtype, tol,
                 slack: float = 10.0) -> bool:
    """True residuals ||A x - theta x|| of the wanted Ritz pairs, checked
    against ``slack * tol`` (tol is already ||A||-scaled).  State-domain
    vectors are zero-padded beyond n, so norms match natural order."""
    for i in order:
        x = mm(V[:, :k], jnp.asarray(Y[:, i], dtype))
        nx = float(jnp.linalg.norm(x))
        if nx == 0.0:
            return False
        true_abs = float(
            jnp.linalg.norm(_dist_spmv_any(Adist, x, mesh) - float(d[i]) * x)
        ) / nx
        if true_abs > slack * tol:
            return False
    return True


def dist_impl_restarted_ca_lanczos(
    A,
    r,
    max_lanczos: int,
    mesh: Mesh,
    n_wanted: int = 10,
    s: int = 4,
    basis: Basis = Basis.NEWTON,
    tol: float = 1.0e-6,
    max_restarts: int = 40,
    qr_method: str = "tsqr",
    mixed_precision: bool = False,
) -> IRLResult:
    """Distributed IRL (impl_restarted_ca_lanczos.m intended design): CA
    inner iteration with a full-history cleanup pass per block (the IRL
    compression makes the retained columns dense mixtures, so local-only
    orthogonalization is insufficient — mirrors the single-chip driver's
    orth=FULL).  A may be a DiaMatrix or an EllMatrix."""
    basis = Basis(basis)
    norm_A = normest(A)
    tol = tol * norm_A

    k = n_wanted + 4
    k = s * (-(-k // s))  # CA blocks must tile the window
    p = s * ((max_lanczos - k) // s)
    m = k + p
    if p <= 0:
        raise ValueError(f"max_lanczos={max_lanczos} too small for k={k} + s={s}")

    r_np = np.asarray(r, np.float64)
    q_host = r_np / np.linalg.norm(r_np)
    if basis == Basis.MONOMIAL:
        Bk = monomial_basis_matrix(s)
    else:
        Bk = build_basis_matrix(A, jnp.asarray(q_host), s, basis)
    diag_np, sub_np = newton_coeffs(Bk)

    Adist = partition_operator(A, mesh, s_max=s)
    n_state = Adist.n_shards * Adist.n_local
    q = Adist.shard_vector(q_host, mesh)
    # IRL state dtype follows the ENTRY vector, not the operator: the
    # implicit restart compresses and re-extends the same basis for many
    # cycles, and f32 state loses enough orthogonality for the
    # beta*|Y[k-1]| estimate to lock spurious Ritz values (round-3 red
    # test: fabricated 167.64 reported converged).  An f64 caller gets
    # f64 compression/orthogonalization on every operator.
    want = jax.dtypes.canonicalize_dtype(np.asarray(r).dtype)
    if np.issubdtype(want, np.floating) and q.dtype != want:
        q = q.astype(want)
    dtype = q.dtype
    diag = jnp.asarray(diag_np, dtype)
    sub = jnp.asarray(sub_np, dtype)
    shard = NamedSharding(mesh, row_spec(mesh))

    def extend(V: Optional[jax.Array], T: np.ndarray, k0: int):
        """Extend the sharded factorization to m+1 columns by CA blocks.

        V: (n_state, m+1) sharded (or None on the first call); column k0 is
        the current residual direction.
        """
        b_prev = T[k0, k0 - 1] if k0 > 0 else 0.0
        nvecs = k0
        if nvecs == 0:
            Qb, Rk = dist_first_block(Adist, q, diag, sub, s, mesh,
                                      qr_method, mp=mixed_precision)
            V = jnp.zeros((n_state, m + 1), dtype, device=shard)
            V = V.at[:, : s + 1].set(Qb)
            Tk, b_new = first_block_T(np.asarray(Rk, np.float64), Bk, s)
            T[: s + 1, :s] = Tk
            b_prev = b_new
            nvecs = s
        while nvecs <= m - s:
            Q_prev = V[:, nvecs - s : nvecs + 1]
            Q_new, Rkk, R = dist_ca_block(Adist, Q_prev, diag, sub, s,
                                          mesh, qr_method,
                                          mp=mixed_precision)
            # Full-history cleanup: after the implicit restart the
            # compressed V_k columns are dense mixtures, so new Krylov
            # directions must be orthogonalized against ALL of them, not
            # just the trailing block (the single-chip IRL does the same
            # via orth=FULL).  V is fixed-width with zero future columns,
            # so one static-shape reorth serves every block.
            Q_new = _dist_reorth(V, Q_new, mesh, qr_method,
                                 mp=mixed_precision)
            V = V.at[:, nvecs + 1 : nvecs + s + 1].set(Q_new)
            Tk, b_new, _ = block_T(
                np.asarray(Rkk, np.float64), np.asarray(R, np.float64), Bk, b_prev, s
            )
            T[nvecs : nvecs + s, nvecs : nvecs + s] = Tk
            T[nvecs, nvecs - 1] = b_prev
            T[nvecs - 1, nvecs] = b_prev
            T[nvecs + s, nvecs + s - 1] = b_new
            if nvecs + s < T.shape[1]:
                T[nvecs + s - 1, nvecs + s] = 0.0
            b_prev = b_new
            nvecs += s
        return V, T, float(T[m, m - 1])

    V: Optional[jax.Array] = None
    T = np.zeros((m + 1, m))
    n_restarts = 0
    converged = False
    while n_restarts < max_restarts:
        n_restarts += 1
        k0 = 0 if n_restarts == 1 else k
        V, T, beta_m = extend(V, T, k0)

        Tm = T[:m, :m].copy()
        theta = np.linalg.eigvalsh((Tm + Tm.T) / 2)
        shifts = theta[:p]

        r_vec = beta_m * V[:, m]
        Qh = np.eye(m)
        H = Tm
        for mu in shifts:
            Qh, H = qrstep(Qh, H, mu, 0, m)

        # Sharded compression: V_k = V Q[:, :k]; residual update.  Host
        # scalars are cast to the state dtype explicitly (an f64 scalar
        # would silently promote f32 state and the .set below would
        # emit JAX's unsafe-cast FutureWarning).
        Vk_new = mm(V[:, :m], jnp.asarray(Qh[:, :k], dtype))
        r_new = (
            mm(V[:, :m], jnp.asarray(Qh[:, k] * H[k, k - 1], dtype))
            + r_vec * jnp.asarray(Qh[m - 1, k - 1], dtype)
        )
        beta_k = float(jnp.linalg.norm(r_new))

        T = np.zeros((m + 1, m))
        T[:k, :k] = H[:k, :k]
        T[k, k - 1] = beta_k
        T[k - 1, k] = beta_k
        V = jnp.zeros((n_state, m + 1), dtype, device=shard)
        V = V.at[:, :k].set(Vk_new)
        V = V.at[:, k].set(r_new / beta_k)

        Tk_sym = (T[:k, :k] + T[:k, :k].T) / 2
        d, Y = np.linalg.eigh(Tk_sym)
        rnorms = beta_k * np.abs(Y[k - 1, :])
        order = np.argsort(d)[::-1][:n_wanted]
        if int(np.sum(rnorms[order] < tol)) >= n_wanted:
            # True-residual verification before declaring convergence:
            # the beta_k*|Y[k-1,:]| estimate trusts the compressed basis'
            # orthogonality, which repeated IRL compressions can lose in
            # reduced precision — the round-3 red test locked a spurious
            # Ritz value this way.  One SpMV per wanted pair, only when
            # the estimate already passes (reference seam:
            # impl_restarted_ca_lanczos.m:110-155's honest convergence
            # intent; same guard family as dist_restarted's
            # verify_locked).
            if _verify_ritz(Adist, V, Y, d, order, k, mesh, dtype, tol):
                converged = True
                break

    Tk_sym = (T[:k, :k] + T[:k, :k].T) / 2
    d, Y = np.linalg.eigh(Tk_sym)
    order = np.argsort(d)[::-1][:n_wanted]
    eigs = d[order]
    rnorms = (float(T[k, k - 1]) * np.abs(Y[k - 1, :]))[order]
    Q_conv = Adist.gather_columns(mm(V[:, :k], jnp.asarray(Y[:, order], dtype)))
    return IRLResult(
        eigs=eigs, Q_conv=Q_conv, n_restarts=n_restarts,
        conv_rnorms=rnorms, converged=converged,
    )
