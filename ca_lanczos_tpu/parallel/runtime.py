"""Multi-host runtime and scaling harness.

The reference is single-process MATLAB; the framework's "communication
backend" is XLA's collective stack (SURVEY.md section 2b) — no custom
transport.  This module provides the thin runtime glue:

* ``initialize_multihost`` — jax.distributed bring-up for multi-host
  runs (call once per host before building the mesh).
* ``scaling_sweep`` — weak/strong-scaling measurement of the distributed
  matrix-powers kernel across mesh widths: nnz/s and parallel efficiency
  per device count (the north-star scaling metric).  On a CPU
  backend the numbers validate plumbing, not performance.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.parallel.distributed import DistDia, dist_matrix_powers
from ca_lanczos_tpu.parallel.mesh import make_hier_mesh, make_mesh
from ca_lanczos_tpu.utils.matrices import laplacian_1d


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize jax.distributed (no-op when single-process env vars are
    absent and no coordinator is given).  Returns the global device count."""
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return len(jax.devices())


def scaling_sweep(
    device_counts: Sequence[int],
    rows_per_device: int = 1 << 18,
    s: int = 8,
    reps: int = 5,
    dtype=jnp.float32,
    n_hosts: Optional[int] = None,
) -> List[Dict]:
    """Weak-scaling sweep of dist_matrix_powers: the problem grows with
    the mesh (rows_per_device per device), ideal efficiency = flat time.

    n_hosts: build hierarchical ('host','chip') meshes with this many
    hosts (mesh.make_hier_mesh) instead of the flat ring — the
    inter-host-aware collective path a multi-host run takes.

    Returns one record per device count with nnz/s and efficiency vs the
    smallest mesh."""
    records = []
    base_rate = None
    for P in device_counts:
        n = rows_per_device * P
        A = laplacian_1d(n, dtype=dtype)
        mesh = (
            make_hier_mesh(n_hosts, P // n_hosts)
            if n_hosts and P % n_hosts == 0 and P > n_hosts
            else make_mesh(P)
        )
        Adist = DistDia.from_dia(A, mesh, s_max=s)
        x = Adist.shard_vector(np.ones(n, np.dtype(dtype).type), mesh)
        z = jnp.zeros(s, x.dtype)
        V = dist_matrix_powers(Adist, x, s, z, z, mesh)
        jax.block_until_ready(V)
        t0 = time.perf_counter()
        for _ in range(reps):
            V = dist_matrix_powers(Adist, V[:, s] , s, z, z, mesh)
        jax.block_until_ready(V)
        dt = (time.perf_counter() - t0) / reps
        rate = A.nnz * s / dt
        per_dev = rate / P
        if base_rate is None:
            base_rate = per_dev
        records.append(
            {
                "devices": P,
                "rows": n,
                "nnz_per_s": rate,
                "nnz_per_s_per_device": per_dev,
                "weak_efficiency": per_dev / base_rate,
                "seconds_per_block": dt,
            }
        )
    return records
