"""Row-sharded ELL operator with halo exchange for general sparsity.

Generalizes parallel.distributed.DistDia beyond banded structure: rows
are partitioned in contiguous blocks; each shard stores its ELL rows
PLUS the matrix rows of the s-hop ghost region, with column indices
rebased to the local padded window [start - H, end + H).  The ghost
depth H is s * b where b = max |col - row| is the *effective bandwidth*
of the (reordered) matrix — the graph-partition-agnostic contiguous-block
design of SURVEY.md section 7 ("hard parts"); matrices with unbounded
bandwidth should be bandwidth-reduced (e.g. RCM) before sharding.

The matrix-powers kernel pays one ppermute halo pair per s local
gather-SpMVs, exactly like the DIA path.
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

from ca_lanczos_tpu.ops.spmv import EllMatrix
from ca_lanczos_tpu.parallel.distributed import RowStateMixin, _halo_exchange
from ca_lanczos_tpu.parallel.mesh import ROWS, RowAxes, row_axes, row_spec


@register_dataclass
@dataclasses.dataclass(frozen=True)
class DistEll(RowStateMixin):
    """Row-sharded ELL operator with an s-deep matrix halo.

    vals/cols: (P, n_local + 2*halo, k) per-shard padded ELL rows; cols
    are LOCAL indices into the padded vector window (zero-valued padding
    entries point at index 0).
    """

    vals: jax.Array
    cols: jax.Array
    halo: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    periodic: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # Partition-time s bound: the halo was sized for this s_max, so any
    # powers call with s > s_max would silently contaminate center rows
    # (ADVICE r4).  0 = legacy/unknown (unchecked).
    s_max: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def n_shards(self) -> int:
        return self.vals.shape[0]

    @property
    def n_local(self) -> int:
        return self.vals.shape[1] - 2 * self.halo

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @staticmethod
    def from_ell(
        A: EllMatrix, mesh: Mesh, s_max: int, periodic: bool = False
    ) -> "DistEll":
        """Partition an ELL operator; ``periodic=True`` measures bandwidth
        in RING distance (min(|c-r|, n-|c-r|)) and rebases wrap columns
        into the ghost regions, which the ring halo exchange then fills
        from the opposite end (runLanczos.m:15-18 wrap structure)."""
        sv, sc, halo, n = ell_shard_planes(A, mesh.devices.size, s_max, periodic)
        sharding = NamedSharding(mesh, row_spec(mesh))
        return DistEll(
            vals=jax.device_put(jnp.asarray(sv), sharding),
            cols=jax.device_put(jnp.asarray(sc, jnp.int32), sharding),
            halo=halo,
            n=n,
            periodic=periodic,
            s_max=s_max,
        )


def ell_shard_planes(A: EllMatrix, P_: int, s_max: int, periodic: bool = False):
    """Host-side partition of an ELL operator into per-shard padded
    windows: returns (vals (P, m, k), cols (P, m, k) window-local,
    halo, n) as numpy."""
    vals = np.asarray(A.vals)
    cols = np.asarray(A.cols)
    n, kk = vals.shape
    # Effective bandwidth over structural nonzeros.
    rows = np.arange(n)[:, None]
    dist = np.where(vals != 0, np.abs(cols - rows), 0)
    if periodic:
        dist = np.minimum(dist, n - dist)
    bw = int(np.max(dist)) if n else 0
    bw = max(bw, 1)
    n_local = -(-n // P_)
    n_pad = n_local * P_
    halo = s_max * bw
    if halo >= n_local:
        raise ValueError(
            f"halo {halo} (s_max={s_max} x bandwidth {bw}) >= rows/shard "
            f"{n_local}: reduce bandwidth (e.g. RCM reorder) or lower s"
        )
    if periodic:
        if n_pad != n:
            raise ValueError(
                f"periodic operator: n={n} must divide evenly over {P_} shards"
            )
        if P_ > 1 and n_local + 2 * halo > n:
            raise ValueError(
                "periodic window exceeds the ring: increase rows/device"
            )
    gv = np.zeros((n_pad + 2 * halo, kk), vals.dtype)
    gc = np.zeros((n_pad + 2 * halo, kk), np.int64)
    gv[halo : halo + n] = vals
    gc[halo : halo + n] = cols
    if periodic:
        gv[:halo] = vals[n - halo :]
        gc[:halo] = cols[n - halo :]
        gv[halo + n :] = vals[:halo]
        gc[halo + n :] = cols[:halo]
    sv, sc = [], []
    for p in range(P_):
        lo = p * n_local  # global row of padded-window start (row lo - halo)
        v = gv[lo : lo + n_local + 2 * halo]
        c = gc[lo : lo + n_local + 2 * halo].copy()
        # Rebase global columns to the local window [lo - halo, ...).
        if periodic:
            c = (c - (lo - halo)) % n
        else:
            c = c - (lo - halo)
        # Structural zeros and (for edge shards) columns outside the
        # window are masked to value 0 / index 0.
        valid = (v != 0) & (c >= 0) & (c < n_local + 2 * halo)
        c = np.where(valid, c, 0)
        v = np.where(valid, v, 0)
        sv.append(v)
        sc.append(c)
    return np.stack(sv), np.stack(sc), halo, n


def _ell_powers_local(
    vals, cols, x_local, diag, sub, halo: int, n_shards: int, s: int,
    periodic: bool = False, axes: RowAxes = ROWS,
):
    """One halo exchange + s local gather-SpMV recurrence steps."""
    xp = _halo_exchange(x_local, halo, n_shards, periodic, axes)

    def matvec(v):
        return jnp.sum(vals * jnp.take(v, cols, axis=0), axis=1)

    def step(carry, coeffs):
        v_km1, v_k = carry
        d, sb = coeffs
        w = matvec(v_k) - d * v_k - sb * v_km1
        return (v_k, w), w

    zero = jnp.zeros_like(xp)
    _, ws = lax.scan(step, (zero, xp), (diag[:s], sub[:s]))
    n_local = x_local.shape[0]
    center = ws[:, halo : halo + n_local]
    return jnp.concatenate([x_local[None, :], center], axis=0).T


@partial(jax.jit, static_argnames=("s", "mesh"))
def dist_ell_matrix_powers(
    A: DistEll, x: jax.Array, s: int, diag: jax.Array, sub: jax.Array, mesh: Mesh
) -> jax.Array:
    """Distributed matrix powers for general ELL sparsity."""

    def body(v_block, c_block, x_local, dg, sb):
        return _ell_powers_local(
            v_block[0], c_block[0], x_local, dg, sb,
            halo=A.halo, n_shards=A.n_shards, s=s, periodic=A.periodic,
            axes=row_axes(mesh),
        )

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            row_spec(mesh), row_spec(mesh), row_spec(mesh),
            PartitionSpec(), PartitionSpec(),
        ),
        out_specs=row_spec(mesh),
    )(A.vals, A.cols, x, diag, sub)
