"""ca_lanczos_tpu — a communication-avoiding Lanczos framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the MATLAB
reference ``magnusgrandin/ca-lanczos`` (Hoemmen-style CA-Lanczos): standard,
s-step, explicitly- and implicitly-restarted (CA-)Lanczos eigensolvers plus
Lanczos time propagators, with monomial and Newton (Leja-shifted) Krylov
bases and four (re)orthogonalization strategies.

Architecture (accelerator-first, not a MATLAB port):

* Large arrays (operators, Krylov multivectors) live on device as JAX
  arrays; heavy ops (matrix powers, block Gram products, TSQR) are jitted
  plain XLA.
* Small matrices (R factors, the tridiagonal T, change-of-basis Bk, Leja
  shift selection, the omega recurrence) are O(s^2) host math in float64.
* Multi-device distribution is row-sharding over a ``jax.sharding.Mesh``
  axis ``'rows'``; halo exchange rides ``ppermute``, TSQR reduces R
  factors via an all-gather tree — see ``ca_lanczos_tpu.parallel``.
"""

from ca_lanczos_tpu.config import Basis, Orth, LejaVariant, RestartStrategy, QrMethod, OrthParams, LanczosConfig
from ca_lanczos_tpu.ops.spmv import DiaMatrix, EllMatrix, DenseMatrix, spmv, normest
from ca_lanczos_tpu.ops.matrix_powers import (
    matrix_powers_monomial,
    matrix_powers_newton,
    matrix_powers,
)
from ca_lanczos_tpu.ops.qr import tsqr, cholqr
from ca_lanczos_tpu.ops.orth import normalize, project, project_and_normalize
from ca_lanczos_tpu.basis.leja import leja, count_multiplicities
from ca_lanczos_tpu.basis.newton import newton_basis_matrix

__all__ = [
    "Basis",
    "Orth",
    "LejaVariant",
    "RestartStrategy",
    "QrMethod",
    "OrthParams",
    "LanczosConfig",
    "DiaMatrix",
    "EllMatrix",
    "DenseMatrix",
    "spmv",
    "normest",
    "matrix_powers_monomial",
    "matrix_powers_newton",
    "matrix_powers",
    "tsqr",
    "cholqr",
    "normalize",
    "project",
    "project_and_normalize",
    "leja",
    "count_multiplicities",
    "newton_basis_matrix",
]

__version__ = "0.1.0"
