from ca_lanczos_tpu.parallel.mesh import (
    CHIP,
    HOST,
    ROWS,
    make_hier_mesh,
    make_mesh,
    replicated,
    row_axes,
    row_sharding,
    row_spec,
)
from ca_lanczos_tpu.parallel.dist_orth import psum_rows
from ca_lanczos_tpu.parallel.distributed import (
    DistDia,
    dist_matrix_powers,
    dist_matrix_powers_rows,
    dist_spmv,
)
from ca_lanczos_tpu.parallel.dist_orth import (
    local_tsqr,
    local_cholqr,
    local_gram,
    local_project,
    local_norm,
)
from ca_lanczos_tpu.parallel.step import (
    dist_first_block,
    dist_ca_block,
    newton_coeffs,
    partition_operator,
)
from ca_lanczos_tpu.parallel.auto import dist_solve_auto, route_dist_operator
from ca_lanczos_tpu.parallel.driver import dist_ca_lanczos, dist_lanczos, DistCaLanczosResult
from ca_lanczos_tpu.parallel.dist_bsr import DistBsr, dist_bsr_matrix_powers
from ca_lanczos_tpu.parallel.dist_ell import DistEll, dist_ell_matrix_powers
from ca_lanczos_tpu.parallel.dist_irl import dist_impl_restarted_ca_lanczos
from ca_lanczos_tpu.parallel.dist_sstep import dist_sstep_lanczos
from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos
from ca_lanczos_tpu.parallel.runtime import initialize_multihost, scaling_sweep

__all__ = [
    "make_mesh",
    "make_hier_mesh",
    "row_sharding",
    "row_spec",
    "row_axes",
    "replicated",
    "psum_rows",
    "ROWS",
    "HOST",
    "CHIP",
    "DistDia",
    "dist_matrix_powers",
    "dist_matrix_powers_rows",
    "dist_spmv",
    "local_tsqr",
    "local_cholqr",
    "local_gram",
    "local_project",
    "local_norm",
    "dist_first_block",
    "dist_ca_block",
    "newton_coeffs",
    "partition_operator",
    "dist_solve_auto",
    "route_dist_operator",
    "dist_ca_lanczos",
    "dist_lanczos",
    "DistCaLanczosResult",
    "DistBsr",
    "DistEll",
    "dist_ell_matrix_powers",
    "dist_bsr_matrix_powers",
    "dist_impl_restarted_ca_lanczos",
    "dist_sstep_lanczos",
    "dist_restarted_ca_lanczos",
    "initialize_multihost",
    "scaling_sweep",
]
