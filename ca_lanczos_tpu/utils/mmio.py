"""Matrix Market loader: ctypes binding to the native C++ parser with a
pure-Python fallback.

The reference's corpus is SuiteSparse .mat files loaded in MATLAB
(test_restarted_ca_lanczos_all_matrices.m:24-32); the portable
interchange format here is .mtx.  The native parser (native/mmio.cpp)
streams multi-GB files at fscanf rate and expands symmetric storage;
``load_mtx`` returns COO numpy arrays, ``load_operator`` converts to the
device operator formats (ELL for general sparsity, DIA when banded).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    from ca_lanczos_tpu.utils._native_build import build_native

    # Content-addressed build — see utils/_native_build.py (ADVICE r4).
    so = build_native(os.path.join(_NATIVE_DIR, "mmio.cpp"), ["-O2"])
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.mm_open.restype = ctypes.c_int64
    lib.mm_open.argtypes = [ctypes.c_char_p]
    lib.mm_info.restype = ctypes.c_int
    lib.mm_info.argtypes = [ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int64)] * 3 + [
        ctypes.POINTER(ctypes.c_int)
    ] * 2
    lib.mm_expanded_nnz.restype = ctypes.c_int64
    lib.mm_expanded_nnz.argtypes = [ctypes.c_int64]
    lib.mm_read.restype = ctypes.c_int64
    lib.mm_read.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.mm_close.argtypes = [ctypes.c_int64]
    _LIB = lib
    return lib


def _load_mtx_python(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Pure-Python fallback parser."""
    with open(path) as f:
        header = f.readline().split()
        if len(header) < 5 or header[1] != "matrix" or header[2] != "coordinate":
            raise ValueError(f"unsupported MatrixMarket header in {path}")
        pattern = header[3].lower() == "pattern"
        symmetry = header[4].lower()
        symmetric = symmetry in ("symmetric", "skew-symmetric")
        skew = symmetry == "skew-symmetric"
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, nnz = (int(x) for x in line.split())
        ri, ci, vi = [], [], []
        for _ in range(nnz):
            parts = f.readline().split()
            r, c = int(parts[0]) - 1, int(parts[1]) - 1
            v = 1.0 if pattern else float(parts[2])
            ri.append(r)
            ci.append(c)
            vi.append(v)
            if symmetric and r != c:
                ri.append(c)
                ci.append(r)
                vi.append(-v if skew else v)
    return np.asarray(ri), np.asarray(ci), np.asarray(vi), (rows, cols)


def load_mtx(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Read a .mtx file -> (row_idx, col_idx, values, (rows, cols)) COO,
    symmetric storage expanded.  Uses the native parser when available."""
    lib = _load_lib()
    if lib is None:
        return _load_mtx_python(path)
    h = lib.mm_open(path.encode())
    if h < 0:
        return _load_mtx_python(path)
    try:
        r = ctypes.c_int64()
        c = ctypes.c_int64()
        nz = ctypes.c_int64()
        sym = ctypes.c_int()
        pat = ctypes.c_int()
        lib.mm_info(h, ctypes.byref(r), ctypes.byref(c), ctypes.byref(nz),
                    ctypes.byref(sym), ctypes.byref(pat))
        total = lib.mm_expanded_nnz(h)
        if total < 0:
            raise IOError(f"mm_expanded_nnz failed for {path}")
        ri = np.empty(total, np.int64)
        ci = np.empty(total, np.int64)
        vi = np.empty(total, np.float64)
        got = lib.mm_read(
            h,
            ri.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if got != total:
            raise IOError(f"short read from {path}: {got}/{total}")
        return ri, ci, vi, (r.value, c.value)
    finally:
        lib.mm_close(h)


def load_operator(path: str, dtype=None, dia_max_diags: int = 32):
    """Load a .mtx matrix as a device operator: DIA when the sparsity lives
    on few diagonals, ELL otherwise."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from ca_lanczos_tpu.ops.spmv import DiaMatrix, EllMatrix

    ri, ci, vi, (rows, cols) = load_mtx(path)
    if rows != cols:
        raise ValueError(f"{path}: operator must be square ({rows}x{cols})")
    if dtype is None:
        dtype = jnp.float64
    coo = sp.coo_matrix((vi, (ri, ci)), shape=(rows, cols))
    diags = np.unique(ci - ri)
    if len(diags) <= dia_max_diags:
        dia = sp.dia_matrix(coo)
        data = np.zeros((len(dia.offsets), rows))
        # scipy DIA stores data[d, j] = A[j - off, j]; DiaMatrix wants
        # data[d, i] = A[i, i + off] -> shift each row by its offset.
        for d, off in enumerate(dia.offsets):
            col = dia.data[d]
            if off >= 0:
                data[d, : rows - off] = col[off:]
            else:
                data[d, -off :] = col[: rows + off]
        return DiaMatrix(data=jnp.asarray(data, dtype), offsets=tuple(int(o) for o in dia.offsets))
    return EllMatrix.from_scipy(coo)


def save_mtx(path: str, a, symmetric: bool = False) -> None:
    """Write a dense/scipy matrix as .mtx coordinate real (test fixture
    generation)."""
    import scipy.sparse as sp

    coo = sp.coo_matrix(a)
    with open(path, "w") as f:
        sym = "symmetric" if symmetric else "general"
        f.write(f"%%MatrixMarket matrix coordinate real {sym}\n")
        if symmetric:
            mask = coo.row >= coo.col
            rows, cols, vals = coo.row[mask], coo.col[mask], coo.data[mask]
        else:
            rows, cols, vals = coo.row, coo.col, coo.data
        f.write(f"{coo.shape[0]} {coo.shape[1]} {len(vals)}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")
