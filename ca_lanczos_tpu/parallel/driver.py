"""Distributed CA-Lanczos driver: host control loop over jitted mesh steps.

The large-array state (Krylov basis blocks) lives row-sharded on the mesh;
per outer iteration exactly one jitted step (parallel.step) runs on
device, and the O(s^2) tridiagonal recovery (solvers._block) runs on host
from the replicated R factors — the same split the reference implies
(ca_lanczos.m:150-245) but with the block's communication collapsed to
one halo exchange + one all-gather + two psums.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ca_lanczos_tpu.config import Basis
from ca_lanczos_tpu.ops.precision import vdot
from ca_lanczos_tpu.ops.spmv import DiaMatrix
from ca_lanczos_tpu.solvers._block import block_T, extend_T, first_block_T
from ca_lanczos_tpu.solvers.ca_lanczos import monomial_basis_matrix
from ca_lanczos_tpu.parallel.distributed import DistDia
from ca_lanczos_tpu.parallel.step import dist_ca_block, dist_first_block, newton_coeffs


@dataclasses.dataclass
class DistCaLanczosResult:
    T: np.ndarray  # (s*t, s*t)
    Q_blocks: List[jax.Array]  # row-sharded basis blocks
    beta: np.ndarray
    n: int  # true (unpadded) dimension

    @property
    def Q(self) -> np.ndarray:
        """Gathered dense basis (host), unpadded rows, s*t columns.

        Stored blocks overlap by one column (each block's first column is
        the previous block's last), so drop it when concatenating.
        """
        cols = [np.asarray(self.Q_blocks[0])]
        for B in self.Q_blocks[1:]:
            cols.append(np.asarray(B[:, 1:]))
        Qfull = np.concatenate(cols, axis=1)
        return Qfull[: self.n, : self.T.shape[0]]


def dist_ca_lanczos(
    A,
    r,
    s: int,
    total_steps: int,
    mesh: Mesh,
    basis: Basis = Basis.MONOMIAL,
    Bk: Optional[np.ndarray] = None,
    qr_method: str = "tsqr",
    orth=None,
    mixed_precision: bool = False,
) -> DistCaLanczosResult:
    """Row-sharded CA-Lanczos over ``mesh`` with all four orth modes
    (reference ca_lanczos.m:27-39 offers them everywhere).

    Semantics mirror solvers.ca_lanczos, except the block CGS always runs
    two passes (see parallel.dist_orth).  Orth modes beyond LOCAL reuse
    the restarted driver's fixed-shape machinery: FULL re-orthogonalizes
    every new block against the zero-padded history (one static jitted
    step, ca_lanczos.m:196-197); PERIODIC triggers the same reorth from
    the host omega recurrence (ca_lanczos.m:430-446); SELECTIVE tracks
    converged Ritz vectors in a fixed-width padded basis joined into the
    block projection (ca_lanczos.m:317-336).

    A may be a DiaMatrix (banded) or EllMatrix (general bounded-bandwidth
    sparsity); for the Newton basis pass a precomputed ``Bk`` (e.g. from
    solvers.ca_lanczos.build_basis_matrix on the host operator).
    """
    from ca_lanczos_tpu.config import Orth
    from ca_lanczos_tpu.ops.spmv import normest
    from ca_lanczos_tpu.parallel.restarted import (
        _dist_ca_block_locked,
        _dist_reorth,
        _dist_ritz_vector,
    )
    from ca_lanczos_tpu.utils.diagnostics import OmegaRecurrence

    basis = Basis(basis)
    orth = Orth(orth) if orth is not None else Orth.LOCAL
    t = int(np.ceil(total_steps / s))
    m = s * t
    if Bk is None:
        if basis != Basis.MONOMIAL:
            raise ValueError("newton basis requires an explicit Bk (bootstrap on host)")
        Bk = monomial_basis_matrix(s)
    diag_np, sub_np = newton_coeffs(Bk)

    from ca_lanczos_tpu.parallel.step import partition_operator

    Adist = partition_operator(A, mesh, s_max=s)
    r = np.asarray(r)
    q = Adist.shard_vector(r / np.linalg.norm(r), mesh)
    dtype = q.dtype
    diag = jnp.asarray(diag_np, dtype)
    sub = jnp.asarray(sub_np, dtype)

    _EPS = float(np.finfo(np.float64).eps)
    norm_A = normest(A) if orth in (Orth.PERIODIC, Orth.SELECTIVE) else None
    omega = OmegaRecurrence(norm_A) if orth == Orth.PERIODIC else None
    hist_dtype = np.float64
    Qhist = (
        Adist.state_zeros(m + 1, mesh, hist_dtype)
        if orth in (Orth.FULL, Orth.PERIODIC, Orth.SELECTIVE)
        else None
    )
    # Selective: fixed-width padded Ritz basis (zero columns are CGS
    # no-ops, so one compile serves the whole run).
    r_cap = min(m, 24)
    QRpad = (
        Adist.state_zeros(r_cap, mesh, hist_dtype)
        if orth == Orth.SELECTIVE
        else None
    )
    nritz = 0

    Q_blocks: List[jax.Array] = []
    b = np.zeros(t)
    T: Optional[np.ndarray] = None

    Qb, Rk = dist_first_block(Adist, q, diag, sub, s, mesh, qr_method,
                              mp=mixed_precision)
    Q_blocks.append(Qb)
    T, b[0] = first_block_T(np.asarray(Rk, np.float64), Bk, s)
    if Qhist is not None:
        Qhist = Qhist.at[:, : s + 1].set(Qb)

    for k in range(2, t + 1):
        if orth == Orth.SELECTIVE:
            Q_new, Rkk, R = _dist_ca_block_locked(
                Adist, Q_blocks[-1], QRpad, diag, sub, s, mesh, qr_method,
                mp=mixed_precision,
            )
        else:
            Q_new, Rkk, R = dist_ca_block(
                Adist, Q_blocks[-1], diag, sub, s, mesh, qr_method,
                mp=mixed_precision,
            )
        Tk, b[k - 1], _ = block_T(
            np.asarray(Rkk, np.float64), np.asarray(R, np.float64), Bk, b[k - 2], s
        )
        T = extend_T(T, Tk, b[k - 2], b[k - 1], s)

        if orth == Orth.FULL:
            Q_new = _dist_reorth(Qhist, Q_new, mesh, qr_method,
                                 mp=mixed_precision)
        elif orth == Orth.PERIODIC:
            alpha_d = np.diagonal(T[: s * k, : s * k]).copy()
            beta_d = np.diagonal(T[: s * k + 1, : s * k], -1).copy()
            omega.update(alpha_d, beta_d)
            if omega.max_error_block(s) >= np.sqrt(_EPS):
                Q_new = _dist_reorth(Qhist, Q_new, mesh, qr_method,
                                 mp=mixed_precision)
                omega.reset_block(s)

        if Qhist is not None:
            lo = (k - 1) * s + 1
            Qhist = Qhist.at[:, lo : lo + s].set(Q_new)
        Q_blocks.append(jnp.concatenate([Q_blocks[-1][:, -1:], Q_new], axis=1))

        if orth == Orth.SELECTIVE:
            # Converged-Ritz tracking (ca_lanczos.m:317-336) on host T;
            # Ritz vectors assembled on the mesh from the padded history.
            sk = s * k
            d_k, Vp_k = np.linalg.eigh(T[:sk, :sk])
            conv = [
                i for i in range(sk)
                if b[k - 1] * abs(Vp_k[sk - 1, i]) < norm_A * np.sqrt(_EPS)
            ][:r_cap]
            if len(conv) > nritz:
                nritz = len(conv)
                for j, i in enumerate(conv):
                    w = np.zeros(m + 1)
                    w[:sk] = Vp_k[:, i]
                    y = _dist_ritz_vector(Qhist, jnp.asarray(w, dtype), mesh)
                    QRpad = QRpad.at[:, j].set(y)

    return DistCaLanczosResult(
        T=T[: s * t, : s * t], Q_blocks=Q_blocks, beta=b, n=A.n,
    )


def dist_lanczos(A: DiaMatrix, r, maxiter: int, mesh: Mesh):
    """Distributed standard Lanczos (baseline the CA drivers amortize:
    ONE halo exchange + global dot reductions PER STEP vs one per s
    steps, lanczos.m:85-134).  Local orthogonalization only; returns
    (T (maxiter, maxiter) host, Q (n, maxiter) sharded)."""
    from ca_lanczos_tpu.parallel.distributed import dist_spmv

    Adist = DistDia.from_dia(A, mesh, s_max=1)
    n_pad = Adist.n_shards * Adist.n_local
    r_np = np.asarray(r, np.float64)
    q = Adist.shard_vector(r_np / np.linalg.norm(r_np), mesh)
    dtype = q.dtype

    Q = jnp.zeros((n_pad, maxiter + 1), dtype)
    Q = Q.at[:, 0].set(q)
    alpha = np.zeros(maxiter)
    beta = np.zeros(maxiter)
    for j in range(1, maxiter + 1):
        w = dist_spmv(Adist, Q[:, j - 1], mesh)
        if j > 1:
            w = w - jnp.asarray(beta[j - 2], dtype) * Q[:, j - 2]
        a = float(vdot(Q[:, j - 1], w))  # GSPMD: local partials + psum
        w = w - a * Q[:, j - 1]
        b = float(jnp.linalg.norm(w))
        alpha[j - 1], beta[j - 1] = a, b
        Q = Q.at[:, j].set(w / b)

    T = np.diag(alpha)
    if maxiter > 1:
        T += np.diag(beta[: maxiter - 1], 1) + np.diag(beta[: maxiter - 1], -1)
    return T, Q[: A.n, :maxiter]
