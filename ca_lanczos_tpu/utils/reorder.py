"""Bandwidth reduction: map general sparse matrices onto the fast banded path.

The banded DIA path needs no gather at all, while ELL pays one gather
per stored entry.  For most SuiteSparse-style symmetric matrices, a
reverse Cuthill-McKee reordering shrinks the bandwidth enough to store
the matrix as DIA (or bounded-bandwidth ELL for the distributed halo
machinery) — this module is that bridge.

Eigenvalues are invariant under the symmetric permutation P A P^T;
eigenvectors come back through ``Reordering.restore``.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.ops.spmv import DiaMatrix, EllMatrix


@dataclasses.dataclass
class Reordering:
    """Symmetric permutation bundle: ``A_reordered = A[perm][:, perm]``."""

    A: Union[DiaMatrix, EllMatrix]
    perm: np.ndarray  # new_index -> old_index
    bandwidth_before: int
    bandwidth_after: int

    def restore(self, x) -> np.ndarray:
        """Map vectors/multivectors from reordered back to original row
        order (inverse permutation applied to axis 0)."""
        x = np.asarray(x)
        out = np.empty_like(x)
        out[self.perm] = x
        return out

    def apply(self, x) -> np.ndarray:
        """Map original-order vectors into the reordered space."""
        return np.asarray(x)[self.perm]


def rcm_reorder(
    a,
    dia_max_diags: int = 64,
    symmetric_mode: bool = True,
) -> Reordering:
    """Reverse Cuthill-McKee reordering of a scipy matrix / dense array /
    operator; returns the permuted operator in the narrowest format.

    The permuted matrix becomes DIA when it lives on few diagonals, else
    bounded-bandwidth ELL (both feed the halo machinery).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    if isinstance(a, (DiaMatrix, EllMatrix)):
        a = sp.csr_matrix(np.asarray(a.to_dense()))
    elif not sp.issparse(a):
        a = sp.csr_matrix(np.asarray(a))
    else:
        a = sp.csr_matrix(a)

    coo0 = a.tocoo()
    bw_before = int(np.max(np.abs(coo0.row - coo0.col))) if coo0.nnz else 0

    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=symmetric_mode))
    ap = a[perm][:, perm].tocoo()
    bw_after = int(np.max(np.abs(ap.row - ap.col))) if ap.nnz else 0

    diags = np.unique(ap.col - ap.row)
    if len(diags) <= dia_max_diags:
        n = ap.shape[0]
        data = np.zeros((len(diags), n))
        dmap = {int(d): i for i, d in enumerate(diags)}
        for r, c, v in zip(ap.row, ap.col, ap.data):
            data[dmap[int(c - r)], r] += v
        A = DiaMatrix(data=jnp.asarray(data), offsets=tuple(int(d) for d in diags))
    else:
        A = EllMatrix.from_scipy(ap)
    return Reordering(A=A, perm=perm, bandwidth_before=bw_before, bandwidth_after=bw_after)
