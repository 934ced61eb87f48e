"""BSR (block sparse row) operator: dense (bm, bn) tiles.

The north-star scaling config runs s-step CA-Lanczos on a >=10M-row BSR
matrix (BASELINE.json configs[4]).  BSR is the format for FEM/multiphysics
operators whose sparsity comes in dense node blocks: the SpMV becomes a
batched (kb) small-matmul contraction — one gather per block instead of
the ELL path's per-entry gathers.

Layout: ``vals[i, j]`` is the dense (bm, bn) tile of block-row i at
block-column ``cols[i, j]``; padding tiles are all-zero with an in-range
block column.  Static (nb, kb, bm, bn) shapes keep XLA tiling happy.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_dataclass

from ca_lanczos_tpu.ops.precision import einsum


@register_dataclass
@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    vals: jax.Array  # (nb, kb, bm, bn)
    cols: jax.Array  # (nb, kb) int32 block-column indices

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (self.vals.shape[2], self.vals.shape[3])

    @property
    def n(self) -> int:
        return self.vals.shape[0] * self.vals.shape[2]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)  # square operators only

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        nb, kb, bm, bn = self.vals.shape
        return nb * kb * bm * bn

    def exact_nnz(self) -> int:
        return int(jnp.sum(self.vals != 0))

    def matvec(self, x: jax.Array) -> jax.Array:
        nb, kb, bm, bn = self.vals.shape
        if x.ndim == 1:
            xb = x.reshape(-1, bn)[self.cols]  # (nb, kb, bn)
            y = einsum("ikab,ikb->ia", self.vals, xb)
            return y.reshape(nb * bm)
        m = x.shape[1]
        xb = x.reshape(-1, bn, m)[self.cols]  # (nb, kb, bn, m)
        y = einsum("ikab,ikbm->iam", self.vals, xb)
        return y.reshape(nb * bm, m)

    def to_dense(self) -> jax.Array:
        nb, kb, bm, bn = self.vals.shape
        out = jnp.zeros((nb * bm, nb * bn), self.dtype)
        for j in range(kb):
            rr = jnp.arange(nb)[:, None, None] * bm + jnp.arange(bm)[None, :, None]
            cc = self.cols[:, j][:, None, None] * bn + jnp.arange(bn)[None, None, :]
            rr = jnp.broadcast_to(rr, (nb, bm, bn))
            cc = jnp.broadcast_to(cc, (nb, bm, bn))
            out = out.at[rr, cc].add(self.vals[:, j])
        return out

    @staticmethod
    def from_scipy(a, block_size: int = 8) -> "BsrMatrix":
        """Convert any scipy.sparse matrix; rows/cols padded to a multiple
        of block_size."""
        import scipy.sparse as sp

        n = a.shape[0]
        npad = -(-n // block_size) * block_size
        if npad != n:
            a = sp.bmat(
                [[a, None], [None, sp.eye(npad - n) * 0.0]], format="csr"
            )
        bsr = sp.bsr_matrix(a, blocksize=(block_size, block_size))
        bsr.sort_indices()
        nb = bsr.shape[0] // block_size
        counts = np.diff(bsr.indptr)
        kb = max(1, int(counts.max()))
        vals = np.zeros((nb, kb, block_size, block_size), bsr.dtype)
        cols = np.zeros((nb, kb), np.int32)
        for i in range(nb):
            lo, hi = bsr.indptr[i], bsr.indptr[i + 1]
            vals[i, : hi - lo] = bsr.data[lo:hi]
            cols[i, : hi - lo] = bsr.indices[lo:hi]
        return BsrMatrix(vals=jnp.asarray(vals), cols=jnp.asarray(cols))

    @staticmethod
    def from_dense(a: np.ndarray, block_size: int = 8) -> "BsrMatrix":
        import scipy.sparse as sp

        return BsrMatrix.from_scipy(sp.csr_matrix(np.asarray(a)), block_size)

    def to_dia(self, max_offsets: int = 64):
        """Scalar-DIA view of a block-BANDED operator (host conversion).

        A block-banded BSR converts to a ~(2*bm*bandwidth)-diagonal
        scalar DIA whose powers need no gather at all (which of the two
        is faster on a given card is a measurement, not a rule).  Each
        block entry A[bm*i+b, bm*j+c] lands on scalar offset
        bm*(j-i) + (c-b); raises when the structural block offsets would
        need more than ``max_offsets`` scalar diagonals (unstructured
        block sparsity — keep BSR).
        """
        from ca_lanczos_tpu.ops.spmv import DiaMatrix

        vals = np.asarray(self.vals)
        cols = np.asarray(self.cols)
        nb, kb, bm, bn = vals.shape
        if bm != bn:
            raise ValueError("square blocks only")
        n = nb * bm
        rows_b = np.arange(nb)[:, None]
        d_all = cols - rows_b  # (nb, kb) block offsets
        live = vals.reshape(nb, kb, -1).any(-1)
        ds = np.unique(d_all[live]) if live.any() else np.asarray([0])
        offs = sorted({
            bm * int(d) + c - b
            for d in ds for b in range(bm) for c in range(bn)
        })
        if len(offs) > max_offsets:
            raise ValueError(
                f"block structure needs {len(offs)} scalar diagonals "
                f"(> max_offsets={max_offsets}); not band-convertible"
            )
        data = np.zeros((len(offs), n), vals.dtype)
        oidx = {o: j for j, o in enumerate(offs)}
        for k in range(kb):
            d_k = d_all[:, k]
            for dv in np.unique(d_k[live[:, k]]):
                bi = np.nonzero(live[:, k] & (d_k == dv))[0]
                for b in range(bm):
                    rows = bi * bm + b
                    for c in range(bn):
                        o = bm * int(dv) + c - b
                        # += folds same-offset contributions from
                        # different block diagonals into one plane
                        data[oidx[o], rows] += vals[bi, k, b, c]
        return DiaMatrix(data=jnp.asarray(data), offsets=tuple(offs))
