"""Row-sharded BSR operator with halo exchange (round-4 VERDICT item 6).

The north-star scaling config runs s-step CA-Lanczos on a >=10M-row BSR
matrix across hosts (BASELINE.json configs[4]); BSR is the production
format for FEM/multiphysics operators whose sparsity comes in dense node
blocks (ops/bsr.py).  The distribution design is DistEll's contiguous
block-row windows, one granularity up: each shard stores its BLOCK rows
plus the s-hop ghost block rows, block columns rebased to the local
padded window, and the matrix-powers kernel pays one ppermute halo pair
per s local block-matvec steps.  Driver state rides the shared
RowStateMixin contract, so every dist driver (dist_ca_lanczos /
restarted / IRL) runs on this operator unchanged.

Reference seam: SpMV.m:1-5 (the declared format extension point); the
reference corpus's bcsstk/msc structural matrices are exactly the
node-block sparsity class this format serves.
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

from ca_lanczos_tpu.ops.precision import einsum
from ca_lanczos_tpu.ops.bsr import BsrMatrix
from ca_lanczos_tpu.parallel.distributed import RowStateMixin, _halo_exchange
from ca_lanczos_tpu.parallel.mesh import ROWS, RowAxes, row_axes, row_spec


@register_dataclass
@dataclasses.dataclass(frozen=True)
class DistBsr(RowStateMixin):
    """Row-sharded BSR operator with an s-deep BLOCK-row matrix halo.

    vals: (P, mb, kb, bm, bm) per-shard padded block rows, where
        mb = nb_local + 2*halo_b; cols (P, mb, kb) are LOCAL block
        indices into the padded window (zero tiles point at 0).
    halo_b: ghost depth in block rows (= s_max * block bandwidth).
    """

    vals: jax.Array
    cols: jax.Array
    halo_b: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    # Partition-time s bound: halo_b = s_max * block bandwidth, so any
    # powers call with s > s_max silently contaminates center block rows
    # (ADVICE r4).  0 = legacy/unknown (unchecked).
    s_max: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def n_shards(self) -> int:
        return self.vals.shape[0]

    @property
    def bm(self) -> int:
        return self.vals.shape[3]

    @property
    def nb_local(self) -> int:
        return self.vals.shape[1] - 2 * self.halo_b

    @property
    def n_local(self) -> int:
        return self.nb_local * self.bm

    @property
    def halo(self) -> int:
        """Row-granularity halo (RowStateMixin/_halo_exchange contract)."""
        return self.halo_b * self.bm

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @staticmethod
    def from_bsr(A: BsrMatrix, mesh: Mesh, s_max: int) -> "DistBsr":
        """Partition a BsrMatrix over ``mesh`` with an s_max-deep block
        halo.  Block bandwidth is measured over structural (nonzero)
        tiles; unboundedly-spread block columns should be RCM-reordered
        at the scalar level first (utils.reorder), like DistEll."""
        P_ = int(mesh.devices.size)
        vals = np.asarray(A.vals)
        cols = np.asarray(A.cols)
        nb, kb, bm, bn = vals.shape
        if bm != bn:
            raise ValueError("square blocks only")
        live = vals.reshape(nb, kb, -1).any(axis=2)
        rows_b = np.arange(nb)[:, None]
        bw_b = int(np.max(np.where(live, np.abs(cols - rows_b), 0))) if nb else 0
        bw_b = max(bw_b, 1)
        nb_local = -(-nb // P_)
        nb_pad = nb_local * P_
        halo_b = s_max * bw_b
        if halo_b >= nb_local:
            raise ValueError(
                f"block halo {halo_b} (s_max={s_max} x block bandwidth "
                f"{bw_b}) >= block rows/shard {nb_local}: reduce bandwidth "
                "or lower s"
            )
        gv = np.zeros((nb_pad + 2 * halo_b, kb, bm, bm), vals.dtype)
        gc = np.zeros((nb_pad + 2 * halo_b, kb), np.int64)
        gv[halo_b : halo_b + nb] = vals
        gc[halo_b : halo_b + nb] = cols
        sv, sc = [], []
        for p in range(P_):
            lo = p * nb_local
            v = gv[lo : lo + nb_local + 2 * halo_b]
            c = gc[lo : lo + nb_local + 2 * halo_b] - (lo - halo_b)
            valid = v.reshape(v.shape[0], kb, -1).any(axis=2)
            valid &= (c >= 0) & (c < nb_local + 2 * halo_b)
            sv.append(np.where(valid[..., None, None], v, 0))
            sc.append(np.where(valid, c, 0))
        sharding = NamedSharding(mesh, row_spec(mesh))
        return DistBsr(
            vals=jax.device_put(jnp.asarray(np.stack(sv)), sharding),
            cols=jax.device_put(jnp.asarray(np.stack(sc), jnp.int32), sharding),
            halo_b=halo_b,
            n=A.n,
            s_max=s_max,
        )

    def shard_vector(self, x, mesh: Mesh) -> jax.Array:
        x = np.asarray(x)
        n_pad = self.n_shards * self.n_local
        xp = np.zeros((n_pad,) + x.shape[1:], x.dtype)
        xp[: self.n] = x
        return jax.device_put(
            jnp.asarray(xp), NamedSharding(mesh, row_spec(mesh))
        )


def _bsr_powers_local(
    vals, cols, x_local, diag, sub, halo_b: int, bm: int, n_shards: int,
    s: int, axes: RowAxes = ROWS,
):
    """One halo exchange + s local block-matvec recurrence steps.

    The local step is a batched (bm x bm) x (bm,) tile contraction —
    one gather per structural tile instead of the ELL path's per-entry
    gathers (ops/bsr.py module doc)."""
    xp = _halo_exchange(x_local, halo_b * bm, n_shards, False, axes)
    mb = xp.shape[0] // bm

    def matvec(v):
        xb = v.reshape(mb, bm)[cols]  # (mb, kb, bm)
        return einsum("ikab,ikb->ia", vals, xb).reshape(mb * bm)

    def step(carry, coeffs):
        v_km1, v_k = carry
        d, sb = coeffs
        w = matvec(v_k) - d * v_k - sb * v_km1
        return (v_k, w), w

    zero = jnp.zeros_like(xp)
    _, ws = lax.scan(step, (zero, xp), (diag[:s], sub[:s]))
    n_local = x_local.shape[0]
    center = ws[:, halo_b * bm : halo_b * bm + n_local]
    return jnp.concatenate([x_local[None, :], center], axis=0).T


@partial(jax.jit, static_argnames=("s", "mesh"))
def dist_bsr_matrix_powers(
    A: DistBsr, x: jax.Array, s: int, diag: jax.Array, sub: jax.Array, mesh: Mesh
) -> jax.Array:
    """Distributed matrix powers on block sparsity."""
    from ca_lanczos_tpu.parallel.distributed import check_s_bound

    check_s_bound(A, s)

    def body(v_block, c_block, x_local, dg, sb):
        return _bsr_powers_local(
            v_block[0], c_block[0], x_local, dg, sb,
            halo_b=A.halo_b, bm=A.bm, n_shards=A.n_shards, s=s,
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
