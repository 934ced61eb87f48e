"""Automatic operator-format routing: scipy/dense input -> the operator
format this framework has for its sparsity.

The reference's SpMV abstraction takes whatever sparse matrix MATLAB
hands it (SpMV.m:1-9) and the corpus harness feeds it arbitrary
SuiteSparse structure (test_restarted_ca_lanczos_all_matrices.m:6-14).
``make_operator`` is the production entry for "I have a matrix, give me
an operator":

  1. tiny           -> DenseMatrix  (one matmul beats any sparse path)
  2. few diagonals  -> DiaMatrix    (shifted-slice FMAs, no gather)
  3. scattered      -> RCM reorder, then re-route the permuted matrix
                       through 2 (returns the permutation for vector
                       encode/decode)
  4. everything else-> EllMatrix    (XLA gather over the reordered rows)

The returned ``OperatorRoute`` records the decision and carries the
permutation (identity passthrough when none), so eigenvectors map back
with ``route.restore(V)`` regardless of which branch fired.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.ops.spmv import DenseMatrix, DiaMatrix, EllMatrix

Routable = Union[DenseMatrix, DiaMatrix, EllMatrix]


def dia_from_scipy(
    a,
    max_diags: int = 64,
    waste_cap: float = 8.0,
    dtype=None,
    device: bool = True,
) -> Optional[DiaMatrix]:
    """Build DIA storage from a scipy matrix when it is diagonal-sparse.

    Returns None unless the matrix lives on <= ``max_diags`` distinct
    diagonals AND the dense-plane padding waste ``len(offsets) * n`` stays
    within ``waste_cap`` x nnz (DIA stores every diagonal densely, so
    unbounded waste would just stream zeros).  Vectorized
    O(nnz log nnz) — corpus-scale safe, unlike the per-entry loop in
    ``utils.reorder.rcm_reorder``.

    Plane convention (ops/spmv.py DiaMatrix): data[k, i] = A[i, i + off_k].

    device=False keeps the planes as host numpy — for consumers that
    immediately re-partition on the host (the dist route), so the whole
    operator never lands on one device before it is sharded.
    """
    import scipy.sparse as sp

    coo = sp.coo_matrix(a)
    coo.sum_duplicates()
    n = coo.shape[0]
    if coo.shape[0] != coo.shape[1]:
        raise ValueError("square matrices only")
    if np.iscomplexobj(coo.data):
        raise ValueError(
            "real matrices only (astype would silently drop imaginary "
            "parts); complex propagation flows use the split "
            "representation, see ops.csplit / solvers.propagators"
        )
    if dtype is None:
        dtype = np.float64 if coo.data.dtype == np.float64 else np.float32
    if coo.nnz == 0:
        return DiaMatrix(data=jnp.zeros((1, n), dtype), offsets=(0,))
    offs_e = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offsets = np.unique(offs_e)
    if len(offsets) > max_diags or len(offsets) * n > waste_cap * coo.nnz:
        return None
    data = np.zeros((len(offsets), n), dtype)
    k = np.searchsorted(offsets, offs_e)
    data[k, coo.row] = coo.data.astype(dtype)
    return DiaMatrix(
        data=jnp.asarray(data) if device else data,
        offsets=tuple(int(d) for d in offsets),
    )


@dataclasses.dataclass
class OperatorRoute:
    """Record of a ``make_operator`` decision.

    perm is new_index -> old_index (as in utils.reorder.Reordering);
    None means no reordering was applied and apply/restore are identity.
    """

    format: str  # "dense" | "dia" | "ell"
    perm: Optional[np.ndarray]
    notes: List[str]
    nnz: int
    bandwidth_before: Optional[int] = None
    bandwidth_after: Optional[int] = None

    def apply(self, x) -> np.ndarray:
        """Map original-order vectors/multivectors into operator order."""
        x = np.asarray(x)
        if self.perm is None:
            return x
        return x[self.perm]

    def restore(self, x) -> np.ndarray:
        """Map operator-order vectors/multivectors back to original order."""
        x = np.asarray(x)
        if self.perm is None:
            return x
        out = np.empty_like(x)
        out[self.perm] = x
        return out


def negate_operator(A: Routable) -> Routable:
    """-A in the same encoded format (value planes negated in place of
    a re-encode).  Lanczos drivers lock the LARGEST Ritz pairs (power-
    iteration bias, restarted_ca_lanczos.m:183-201); solving -A and
    negating the eigenvalues back targets the smallest end without new
    machinery."""
    if isinstance(A, DiaMatrix):
        return DiaMatrix(data=-A.data, offsets=A.offsets)
    if isinstance(A, EllMatrix):
        return EllMatrix(vals=-A.vals, cols=A.cols)
    if isinstance(A, DenseMatrix):
        return DenseMatrix(a=-A.a)
    raise TypeError(f"cannot negate {type(A).__name__}")


def save_operator(path: str, A: Routable, route: Optional[OperatorRoute] = None) -> None:
    """Serialize an encoded operator (+ its route) to one ``.npz`` file.

    Encode-once/solve-many: DIA/ELL conversion and the RCM reorder are
    O(nnz log nnz) host work, so deployments can encode once and ship the
    planes.  Round-trips DiaMatrix / EllMatrix / DenseMatrix bit-exactly.
    """
    if isinstance(A, DiaMatrix):
        arrs = dict(kind="dia", data=np.asarray(A.data),
                    offsets=np.asarray(A.offsets, np.int64))
    elif isinstance(A, EllMatrix):
        arrs = dict(kind="ell", vals=np.asarray(A.vals),
                    cols=np.asarray(A.cols))
    elif isinstance(A, DenseMatrix):
        arrs = dict(kind="dense", a=np.asarray(A.a))
    else:
        raise TypeError(f"cannot serialize {type(A).__name__}")
    if route is not None:
        arrs["route_format"] = np.asarray(route.format)
        arrs["route_nnz"] = np.asarray(route.nnz, np.int64)
        arrs["route_notes"] = np.asarray("\n".join(route.notes))
        if route.perm is not None:
            arrs["route_perm"] = np.asarray(route.perm, np.int64)
    np.savez_compressed(path, **arrs)


def load_operator_npz(
    path: str,
) -> Tuple[Routable, Optional[OperatorRoute]]:
    """Inverse of :func:`save_operator`."""
    z = np.load(path, allow_pickle=False)
    kind = str(z["kind"])
    if kind == "dia":
        A: Routable = DiaMatrix(
            data=jnp.asarray(z["data"]),
            offsets=tuple(int(o) for o in z["offsets"]),
        )
    elif kind == "ell":
        A = EllMatrix(vals=jnp.asarray(z["vals"]), cols=jnp.asarray(z["cols"]))
    elif kind == "dense":
        A = DenseMatrix(a=jnp.asarray(z["a"]))
    else:
        raise ValueError(f"unknown operator kind {kind!r} in {path}")
    route = None
    if "route_format" in z:
        notes = str(z["route_notes"])
        route = OperatorRoute(
            format=str(z["route_format"]),
            perm=np.asarray(z["route_perm"]) if "route_perm" in z else None,
            notes=notes.split("\n") if notes else [],
            nnz=int(z["route_nnz"]),
        )
    return A, route


def make_operator(
    a,
    *,
    prefer: str = "auto",
    dense_cutoff: int = 2048,
    max_diags: int = 64,
    dia_waste_cap: float = 8.0,
    allow_reorder: bool = True,
    allow_ell_fallback: bool = True,
    dtype=None,
) -> Tuple[Routable, OperatorRoute]:
    """Route any square scipy.sparse / dense matrix to a device operator.

    prefer: "auto" routes per the module docstring; "dense" / "dia" /
    "ell" force that format ("dia" raises if the matrix does not qualify
    under ``max_diags`` / ``dia_waste_cap``).

    dtype: storage dtype of the operator's values; None keeps float64
    input in float64 and stores anything else as float32.  The two-stage
    pipeline passes float32 here and keeps the float64 matrix for the
    polish (harness.auto.solve_auto).

    Returns (operator, route).  When routing reordered the matrix
    (route.perm is not None) the caller must run the solver on
    ``route.apply(r0)`` and map Ritz vectors back with
    ``route.restore(V)``; eigenVALUES are permutation-invariant.
    """
    import scipy.sparse as sp

    if sp.issparse(a):
        csr = sp.csr_matrix(a)
    else:
        csr = sp.csr_matrix(np.asarray(a))
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("square matrices only")
    if np.iscomplexobj(csr.data):
        raise ValueError(
            "real matrices only (astype would silently drop imaginary "
            "parts); complex propagation flows use the split "
            "representation, see ops.csplit / solvers.propagators"
        )
    csr.sum_duplicates()
    csr.sort_indices()
    if dtype is None:
        dtype = np.float64 if csr.dtype == np.float64 else np.float32
    csr = csr.astype(dtype)
    n = csr.shape[0]
    nnz = int(csr.nnz)
    notes: List[str] = []

    if prefer == "dense" or (prefer == "auto" and n <= dense_cutoff):
        A = DenseMatrix(a=jnp.asarray(csr.toarray()))
        notes.append(f"n={n} <= dense_cutoff={dense_cutoff}"
                     if prefer == "auto" else "forced dense")
        return A, OperatorRoute("dense", None, notes, nnz)
    dia_kw = dict(max_diags=max_diags, waste_cap=dia_waste_cap)
    if prefer == "dia":
        A = dia_from_scipy(csr, **dia_kw)
        if A is None:
            raise ValueError(
                f"matrix does not qualify for DIA (max_diags={max_diags},"
                f" waste_cap={dia_waste_cap})"
            )
        return A, OperatorRoute("dia", None, ["forced dia"], nnz)
    if prefer == "ell":
        return (
            EllMatrix.from_scipy(csr),
            OperatorRoute("ell", None, ["forced ell"], nnz),
        )
    if prefer != "auto":
        raise ValueError(f"unknown prefer={prefer!r}")

    A = dia_from_scipy(csr, **dia_kw)
    if A is not None:
        return A, OperatorRoute("dia", None, notes, nnz)

    perm = None
    bw_before = bw_after = None
    if allow_reorder and nnz:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm = np.asarray(reverse_cuthill_mckee(csr, symmetric_mode=True))
        csr_p = csr[perm][:, perm].tocsr()
        csr_p.sort_indices()
        coo0, coo1 = csr.tocoo(), csr_p.tocoo()
        bw_before = int(np.max(np.abs(coo0.row - coo0.col)))
        bw_after = int(np.max(np.abs(coo1.row - coo1.col)))
        notes.append(f"rcm: bandwidth {bw_before} -> {bw_after}")
        A = dia_from_scipy(csr_p, **dia_kw)
        if A is not None:
            return A, OperatorRoute("dia", perm, notes, nnz, bw_before, bw_after)
        csr = csr_p
    if not allow_ell_fallback:
        raise ValueError(
            "matrix is not diagonal-sparse and the ELL fallback is "
            "disabled: " + "; ".join(notes)
        )
    notes.append("ell fallback (XLA gather)")
    return (
        EllMatrix.from_scipy(csr),
        OperatorRoute("ell", perm, notes, nnz, bw_before, bw_after),
    )
