from ca_lanczos_tpu.ops.spmv import DiaMatrix, EllMatrix, DenseMatrix, spmv, normest
from ca_lanczos_tpu.ops.bsr import BsrMatrix
from ca_lanczos_tpu.ops.matrix_powers import (
    matrix_powers,
    matrix_powers_monomial,
    matrix_powers_newton,
)
from ca_lanczos_tpu.ops.formats import (
    OperatorRoute,
    dia_from_scipy,
    load_operator_npz,
    make_operator,
    save_operator,
)
from ca_lanczos_tpu.ops.qr import tsqr, cholqr
from ca_lanczos_tpu.ops.orth import normalize, project, project_and_normalize

__all__ = [
    "DiaMatrix",
    "EllMatrix",
    "DenseMatrix",
    "BsrMatrix",
    "spmv",
    "normest",
    "matrix_powers",
    "matrix_powers_monomial",
    "matrix_powers_newton",
    "OperatorRoute",
    "dia_from_scipy",
    "load_operator_npz",
    "make_operator",
    "save_operator",
    "tsqr",
    "cholqr",
    "normalize",
    "project",
    "project_and_normalize",
]
