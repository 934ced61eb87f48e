"""Sparse operator formats and SpMV — the L0 kernel layer.

The reference's SpMV is a plain ``A*v`` behind a declared abstraction point
(reference: SpMV.m:1-9, "should be extended to support other data
structures").  Three formats, each a plain XLA computation:

* ``DiaMatrix`` — DIA (diagonal) storage.  SpMV is a sum of shifted
  elementwise multiplies: contiguous loads, zero gathers, one fused
  memory-bound loop under XLA.  This is the format for the reference's
  entire test corpus shape-family (diagonal spectra, banded Laplacians,
  FD Hamiltonians).
* ``EllMatrix`` — ELLPACK (fixed nnz/row, padded).  SpMV is one gather +
  multiply + row reduction; static shapes keep XLA happy.  General
  matrices (SuiteSparse-style) convert to this.
* ``DenseMatrix`` — plain dense matmul.  Oracle/testing path and the
  fastest choice for small n.

All formats are registered pytrees so operators flow through ``jax.jit`` /
``lax.scan`` / ``shard_map`` unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.tree_util import register_dataclass

from ca_lanczos_tpu.ops.precision import mm


def _row_scale(x: jax.Array, d: jax.Array) -> jax.Array:
    """Multiply vector-or-multivector x (n,) / (n,m) rowwise by d (n,)."""
    if x.ndim == 1:
        return d * x
    return d[:, None] * x


@register_dataclass
@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal (DIA) sparse matrix, row-indexed.

    ``data[d, i] = A[i, i + offsets[d]]`` (zero where the column index is
    out of range).  ``offsets`` is static so XLA sees a fixed set of
    shifted slices; SpMV compiles to ``ndiags`` fused multiply-adds with no
    gather — the analogue of the reference's ``A*v`` (SpMV.m:6-8) for
    banded/structured operators.
    """

    data: jax.Array  # (ndiags, n)
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        n = self.n
        return sum(n - abs(k) for k in self.offsets)

    def matvec(self, x: jax.Array) -> jax.Array:
        return _dia_matvec(self.offsets, self.data, x)

    def to_dense(self) -> jax.Array:
        n = self.n
        out = jnp.zeros((n, n), self.dtype)
        rows = jnp.arange(n)
        for d, k in enumerate(self.offsets):
            valid = (rows + k >= 0) & (rows + k < n)
            cols = jnp.clip(rows + k, 0, n - 1)
            out = out.at[rows, cols].add(jnp.where(valid, self.data[d], 0))
        return out

    @staticmethod
    def from_dense(a: np.ndarray, tol: float = 0.0) -> "DiaMatrix":
        a = np.asarray(a)
        n = a.shape[0]
        offsets = []
        data = []
        for k in range(-n + 1, n):
            diag = np.diagonal(a, k)
            if np.any(np.abs(diag) > tol):
                offsets.append(k)
                row = np.zeros(n, a.dtype)
                if k >= 0:
                    row[: n - k] = diag
                else:
                    row[-k:] = diag
                data.append(row)
        return DiaMatrix(data=jnp.asarray(np.stack(data)), offsets=tuple(offsets))


def _dia_matvec(offsets: Tuple[int, ...], data: jax.Array, x: jax.Array) -> jax.Array:
    n = data.shape[1]
    wl = max(0, -min(offsets)) if offsets else 0
    wr = max(0, max(offsets)) if offsets else 0
    pad = [(wl, wr)] + [(0, 0)] * (x.ndim - 1)
    xp = jnp.pad(x, pad)
    y = jnp.zeros_like(x)
    for d, k in enumerate(offsets):
        seg = lax.slice_in_dim(xp, wl + k, wl + k + n, axis=0)
        y = y + _row_scale(seg, data[d])
    return y


@register_dataclass
@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELLPACK sparse matrix: fixed number of (padded) nonzeros per row.

    ``vals[i, j]`` multiplies ``x[cols[i, j]]``; padding entries carry
    ``vals == 0`` with an in-range column index, so no masking is needed at
    SpMV time.  Static (n, k) shapes keep the gather XLA-tileable.
    """

    vals: jax.Array  # (n, k)
    cols: jax.Array  # (n, k) int32

    @property
    def n(self) -> int:
        return self.vals.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        # Padded count; exact nnz requires counting zeros, which we avoid
        # in traced code.  Use ``exact_nnz`` on concrete matrices.
        return self.vals.shape[0] * self.vals.shape[1]

    def exact_nnz(self) -> int:
        return int(jnp.sum(self.vals != 0))

    def matvec(self, x: jax.Array) -> jax.Array:
        gathered = jnp.take(x, self.cols, axis=0)  # (n, k) or (n, k, m)
        if x.ndim == 1:
            return jnp.sum(self.vals * gathered, axis=1)
        return jnp.sum(self.vals[..., None] * gathered, axis=1)

    def to_dense(self) -> jax.Array:
        n = self.n
        out = jnp.zeros((n, n), self.dtype)
        rows = jnp.broadcast_to(jnp.arange(n)[:, None], self.cols.shape)
        return out.at[rows, self.cols].add(self.vals)

    @staticmethod
    def from_dense(a: np.ndarray) -> "EllMatrix":
        import scipy.sparse as sp

        return EllMatrix.from_scipy(sp.csr_matrix(np.asarray(a)))

    @staticmethod
    def from_scipy(a) -> "EllMatrix":
        """Convert a scipy.sparse matrix (any format) to ELL.

        Fully vectorized (no per-row Python loop): nnz are scattered into
        the padded (n, k) slots by flat index, so corpus-scale (multi-
        million-row) conversions stay O(nnz) numpy work.
        """
        import scipy.sparse as sp

        csr = sp.csr_matrix(a)
        csr.sort_indices()
        n = csr.shape[0]
        counts = np.diff(csr.indptr)
        k = max(1, int(counts.max()))
        rows = np.repeat(np.arange(n), counts)
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        vals = np.zeros((n, k), csr.dtype)
        cols = np.zeros((n, k), np.int32)
        vals[rows, slot] = csr.data
        cols[rows, slot] = csr.indices
        return EllMatrix(vals=jnp.asarray(vals), cols=jnp.asarray(cols))


@register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense operator; SpMV is one matmul.  Oracle/testing path."""

    a: jax.Array  # (n, n)

    @property
    def n(self) -> int:
        return self.a.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def nnz(self) -> int:
        return self.a.shape[0] * self.a.shape[1]

    def matvec(self, x: jax.Array) -> jax.Array:
        return mm(self.a, x)

    def to_dense(self) -> jax.Array:
        return self.a


# BsrMatrix (ops.bsr) also satisfies this protocol; kept out of the Union
# to avoid an import cycle — Operator is duck-typed (matvec/shape/dtype/nnz).
Operator = Union[DiaMatrix, EllMatrix, DenseMatrix]


def spmv(A: Operator, x: jax.Array) -> jax.Array:
    """``A @ x`` for any supported operator (reference seam: SpMV.m:6-8)."""
    return A.matvec(x)


@jax.jit
def _normest_step(A: Operator, v: jax.Array):
    w = A.matvec(v)
    nrm = jnp.linalg.norm(w)
    return w / nrm, nrm


def normest(A: Operator, tol: float = 1.0e-6, max_iters: int = 200) -> float:
    """2-norm estimate via power iteration until the estimate changes by
    less than ``tol`` relative (MATLAB ``normest`` analogue).

    Used to scale convergence tolerances (reference:
    restarted_ca_lanczos.m:35-39) and the selective/periodic
    reorthogonalization triggers (lanczos.m:146-147, 250-251).
    """
    n = A.shape[0]
    # Deterministic pseudo-random start: a structured start (e.g. ones)
    # can be an exact null vector — graph/periodic Laplacians annihilate
    # ones, and returning 0 here silently zeroes every tolerance built
    # from it downstream.
    rng = np.random.default_rng(0x5EED)
    v = jnp.asarray(rng.standard_normal(n), jnp.result_type(A.dtype, jnp.float32))
    v = v / jnp.linalg.norm(v)
    est = 0.0
    for _ in range(max_iters):
        v, nrm = _normest_step(A, v)
        new = float(nrm)
        if new == 0.0 or not np.isfinite(new):
            # Landed in (or near) the null space: restart fresh.
            v = jnp.asarray(rng.standard_normal(n), v.dtype)
            v = v / jnp.linalg.norm(v)
            est = 0.0
            continue
        if abs(new - est) <= tol * max(new, 1e-300):
            return new
        est = new
    return est
