"""Row-sharded distributed operator and the halo-exchange matrix-powers kernel.

This is the communication-avoiding core the MATLAB reference only simulates
sequentially (SpMV.m:6-8, matrix_powers_monomial.m:6-12): the matrix is
partitioned in contiguous row blocks over a 1-D ``('rows',)`` mesh and the
s-step Krylov block ``[x, Ax, ..., A^s x]`` is computed with exactly ONE
boundary exchange per s SpMVs:

* each device holds its own matrix rows PLUS the rows of the s-deep ghost
  region (precomputed at partition time — the "matrix halo");
* one ``ppermute`` pair per block pulls the s*w-deep vector halo from the
  ring neighbors (w = operator bandwidth);
* s local banded SpMVs then run entirely on-device: step k pollutes only the
  outermost k*w entries of the padded vector, so the owned center rows
  remain exact for all s steps.

Communication volume per block: 2*s*w elements/device, independent of s in
*rounds* (1 round instead of the s rounds a naive distributed Lanczos pays).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from jax.tree_util import register_dataclass

from ca_lanczos_tpu.ops.spmv import DiaMatrix
from ca_lanczos_tpu.parallel.mesh import ROWS, RowAxes, row_axes, row_spec


def check_s_bound(A, s: int) -> None:
    """Guard a matrix-powers call against the operator's partition-time
    halo depth: the ghost regions were sized for ``s_max`` hops, so a
    deeper call would silently contaminate the owned center rows (ADVICE
    r4).  ``s_max`` == 0 (legacy operators) skips the check; DistDia
    derives its bound from the stored halo."""
    smax = getattr(A, "s_max", 0)
    if smax and s > smax:
        raise ValueError(
            f"s={s} exceeds the operator's partition-time s_max={smax}: "
            "halos were sized at partition time — rebuild the operator "
            "with a larger s_max"
        )


class RowStateMixin:
    """Driver-state API shared by the distributed operator classes.

    Distributed drivers keep their n-sized state (Krylov blocks, locked
    basis, histories) row-sharded in natural order, zero-padded to
    P*n_local rows, and only enter/exit at solve boundaries through this
    API, so the same driver runs on every distributed operator class.
    """

    def state_zeros(self, cols: int, mesh: Mesh, dtype=None) -> jax.Array:
        """Row-sharded zeros in the driver's state layout ((P*n_local,
        cols), or (P*n_local,) with cols=0)."""
        dtype = self.dtype if dtype is None else dtype
        shape = (self.n_shards * self.n_local,) + ((cols,) if cols else ())
        return jax.device_put(
            jnp.zeros(shape, dtype), NamedSharding(mesh, row_spec(mesh))
        )

    def shard_vector(self, x, mesh: Mesh) -> jax.Array:
        """Entry into the driver state layout: zero-pad a host (n,) or
        (n, k) natural-order array to P*n_local rows and row-shard it."""
        x = np.asarray(x)
        xp = np.zeros((self.n_shards * self.n_local,) + x.shape[1:], x.dtype)
        xp[: self.n] = x
        return jax.device_put(jnp.asarray(xp), NamedSharding(mesh, row_spec(mesh)))

    def gather_columns(self, Q) -> np.ndarray:
        """Exit from the driver state layout to natural host order:
        (state, k) or (state,) -> (n, k) / (n,) trimmed."""
        return np.asarray(Q)[: self.n]


@register_dataclass
@dataclasses.dataclass(frozen=True)
class DistDia(RowStateMixin):
    """Row-sharded DIA operator with an s-deep matrix halo.

    data: (P, ndiags, n_local + 2*halo) — shard p holds the DIA data of
        global rows [p*n_local - halo, (p+1)*n_local + halo), zero-padded
        outside [0, n).  Sharded over the leading mesh axis.
    offsets: static diagonal offsets (see ops.spmv.DiaMatrix).
    halo: ghost depth in rows; must be >= s_max * max|offset|.
    """

    data: jax.Array
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    halo: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    periodic: bool = dataclasses.field(default=False, metadata=dict(static=True))

    @property
    def n_shards(self) -> int:
        return self.data.shape[0]

    @property
    def n_local(self) -> int:
        return self.data.shape[2] - 2 * self.halo

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def bandwidth(self) -> int:
        return max(abs(k) for k in self.offsets) if self.offsets else 0

    @property
    def s_max(self) -> int:
        """Largest s the stored halo supports."""
        w = self.bandwidth
        return self.halo // w if w else 10**9

    @staticmethod
    def from_dia(
        A: DiaMatrix,
        mesh: Mesh,
        s_max: int,
        periodic: bool = False,
    ) -> "DistDia":
        """Partition a DIA operator over ``mesh`` with an s_max-deep halo.

        Rows are padded to a multiple of the shard count; padding rows are
        zero (harmless: they contribute nothing and their Krylov entries
        stay zero when the start vector is zero-padded likewise).

        ``periodic=True`` interprets the DIA data as circulant-banded
        (``A[i, (i + off) mod n] = data[d, i]``, the runLanczos wrap) and
        fills the matrix ghost rows from the wrapped end; requires n to
        divide evenly over the shards so the ring stays aligned.
        """
        P_ = mesh.devices.size
        data = np.asarray(A.data)
        ndiags, n = data.shape
        w = max(abs(k) for k in A.offsets) if A.offsets else 0
        n_local = -(-n // P_)
        n_pad = n_local * P_
        halo = max(1, s_max * w)
        if halo >= n_local:
            raise ValueError(
                f"halo {halo} >= shard size {n_local}: increase rows/device or lower s"
            )
        # Global data padded to n_pad rows, then per-shard slices with halo
        # overlap (the matrix ghost rows).
        if periodic and n_pad != n:
            raise ValueError(
                f"periodic operator: n={n} must divide evenly over {P_} shards"
            )
        gdata = np.zeros((ndiags, n_pad + 2 * halo), data.dtype)
        gdata[:, halo : halo + n] = data
        if periodic:
            gdata[:, :halo] = data[:, n - halo :]
            gdata[:, halo + n :] = data[:, :halo]
        shards = np.stack(
            [gdata[:, p * n_local : p * n_local + n_local + 2 * halo] for p in range(P_)]
        )
        sharded = jax.device_put(
            jnp.asarray(shards), NamedSharding(mesh, row_spec(mesh))
        )
        return DistDia(
            data=sharded, offsets=A.offsets, halo=halo, n=n, periodic=periodic,
        )


def _dia_matvec_local(offsets: Tuple[int, ...], data: jax.Array, x: jax.Array) -> jax.Array:
    """Banded matvec on an already-padded local vector; rows line up with
    ``data`` columns.  Same structure as ops.spmv._dia_matvec."""
    m = data.shape[1]
    wl = max(0, -min(offsets)) if offsets else 0
    wr = max(0, max(offsets)) if offsets else 0
    xp = jnp.pad(x, (wl, wr))
    y = jnp.zeros_like(x)
    for d, k in enumerate(offsets):
        y = y + data[d] * lax.slice_in_dim(xp, wl + k, wl + k + m, axis=0)
    return y


def _ring_perms(n_shards: int, periodic: bool):
    """Forward/backward neighbor pairs of the linear shard ring.  On a
    hierarchical mesh the linear index is host-major, so consecutive
    pairs stay inside a host and exactly the ``(h*C + C-1, (h+1)*C)``
    boundary pairs cross hosts."""
    if periodic:
        fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        bwd = [((i + 1) % n_shards, i) for i in range(n_shards)]
    else:
        fwd = [(i, i + 1) for i in range(n_shards - 1)]
        bwd = [(i + 1, i) for i in range(n_shards - 1)]
    return fwd, bwd


def _halo_exchange(
    x_local: jax.Array, halo: int, n_shards: int, periodic: bool = False,
    axes: RowAxes = ROWS,
) -> jax.Array:
    """Pull ``halo`` rows from each ring neighbor; edge shards get zeros
    (ppermute semantics — correct for non-periodic operators whose halo
    rows beyond the boundary are zero).  With ``periodic=True`` the ring
    closes: edge shards pull the wrapped rows from the opposite end, so
    circulant-banded operators (the reference's periodic FD Hamiltonian,
    runLanczos.m:15-18) distribute like any banded operator.

    ``axes``: the mesh row-axis handle.  On a hierarchical (host, chip)
    mesh the single ppermute runs over the linearized axes — the
    intra-host pairs stay inside a host and only the 2*(H-1)
    host-boundary pairs (2H when periodic) cross hosts, the minimum for
    a ring exchange."""
    fwd, bwd = _ring_perms(n_shards, periodic)
    with jax.named_scope("halo_exchange"):
        left = lax.ppermute(x_local[-halo:], axes, perm=fwd)
        right = lax.ppermute(x_local[:halo], axes, perm=bwd)
        return jnp.concatenate([left, x_local, right])


def _powers_local(
    data_local: jax.Array,
    x_local: jax.Array,
    diag: jax.Array,
    sub: jax.Array,
    offsets: Tuple[int, ...],
    halo: int,
    n_shards: int,
    s: int,
    transposed: bool = False,
    include_q: bool = True,
    periodic: bool = False,
    axes: RowAxes = ROWS,
) -> jax.Array:
    """One halo exchange + s local three-term-recurrence SpMVs.

    Implements V[:,k+1] = A V[:,k] - diag[k] V[:,k] - sub[k] V[:,k-1] on
    the padded vector; returns the owned center (n_local, s+1), or
    (s+1, n_local) with ``transposed=True`` — the scan's natural
    layout, which avoids materializing a transpose at a shard_map
    boundary (callers transpose lazily outside).
    """
    xp = _halo_exchange(x_local, halo, n_shards, periodic, axes)
    n_local = x_local.shape[0]

    def step(carry, coeffs):
        v_km1, v_k = carry
        d, sb = coeffs
        w = _dia_matvec_local(offsets, data_local, v_k) - d * v_k - sb * v_km1
        return (v_k, w), w

    zero = jnp.zeros_like(xp)
    _, ws = lax.scan(step, (zero, xp), (diag[:s], sub[:s]))
    center = ws[:, halo : halo + n_local]  # (s, n_local)
    if not include_q:
        return center if transposed else center.T
    V = jnp.concatenate([x_local[None, :], center], axis=0)
    return V if transposed else V.T  # (n_local, s+1) by default


def dia_powers_statics(A: DistDia, s: int, axes: RowAxes = ROWS) -> dict:
    """Static _powers_local kwargs for an operator (shared threading)."""
    return dict(
        offsets=A.offsets, halo=A.halo, n_shards=A.n_shards, s=s,
        periodic=A.periodic, axes=axes,
    )


@partial(jax.jit, static_argnames=("s", "mesh"))
def dist_matrix_powers(
    A: DistDia,
    x: jax.Array,
    s: int,
    diag: jax.Array,
    sub: jax.Array,
    mesh: Mesh,
) -> jax.Array:
    """Distributed matrix-powers kernel: x (n_pad,) row-sharded ->
    V (n_pad, s+1) row-sharded.  ``diag``/``sub`` are the Newton recurrence
    coefficients ((0, 0) vectors give the monomial basis).

    PERFORMANCE: this convenience layout (leading q column + (n, s+1)
    transpose) adds copies when the consumer only chains powers.
    Chained callers should use
    ``dist_matrix_powers_rows`` (the layout the drivers use internally);
    this wrapper is the reference-shaped API (matrix_powers.m:1-13)."""
    # The rows-native block (s, n_pad) is the scan's natural layout;
    # prepending q and transposing happen OUTSIDE the shard_map boundary
    # where XLA fuses them into consumers instead of materializing extra
    # (n, s+1) copies.
    W = dist_matrix_powers_rows(A, x, s, diag, sub, mesh)
    return jnp.concatenate([x[None, :], W], axis=0).T


@partial(jax.jit, static_argnames=("s", "mesh"))
def dist_matrix_powers_rows(
    A: DistDia,
    x: jax.Array,
    s: int,
    diag: jax.Array,
    sub: jax.Array,
    mesh: Mesh,
) -> jax.Array:
    """Rows-native distributed matrix powers: returns W (s, n_pad) — the
    s recurrence vectors WITHOUT the leading q row or any transpose.

    This is the performance-path variant of ``dist_matrix_powers``: the
    shard_map boundary materializes only the kernel's natural (s, n)
    layout, so a chained consumer (power iteration, bench, scaling sweep)
    reads W[s-1] as a cheap row slice instead of paying the q-concat +
    transpose copies the (n, s+1) API forces.
    """
    check_s_bound(A, s)
    inner = partial(
        _powers_local, transposed=True, include_q=False,
        **dia_powers_statics(A, s, row_axes(mesh)),
    )

    def body(data_block, x_local, dg, sb):
        return inner(data_block[0], x_local, dg, sb)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(row_spec(mesh), row_spec(mesh), PartitionSpec(), PartitionSpec()),
        out_specs=row_spec(mesh, lead_none=1),
    )(A.data, x, diag, sub)


@partial(jax.jit, static_argnames=("mesh",))
def dist_spmv(A: DistDia, x: jax.Array, mesh: Mesh) -> jax.Array:
    """Single distributed SpMV (1-deep use of the stored halo)."""
    def body(data_block, x_local):
        data = data_block[0]
        xp = _halo_exchange(x_local, A.halo, A.n_shards, A.periodic,
                            row_axes(mesh))
        y = _dia_matvec_local(A.offsets, data, xp)
        return y[A.halo : A.halo + x_local.shape[0]]

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(row_spec(mesh), row_spec(mesh)),
        out_specs=row_spec(mesh),
    )(A.data, x)
