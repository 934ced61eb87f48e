"""Device mesh construction for row-sharded CA-Lanczos.

The meaningful parallel axis for this workload is the matrix row dimension
(SURVEY.md section 2b): vectors and Krylov multivectors are sharded over
the mesh's row axes; the matrix-powers kernel exchanges s-deep halos with
``ppermute`` and all reductions (Gram matrices, TSQR R factors, norms)
ride ``psum``/``all_gather``.

Two mesh shapes are supported (SURVEY.md §2b, multi-host runtime row):

* **flat** ``('rows',)`` — a single ring over all devices (``make_mesh``);
  the mesh for the cards of one host, which reach each other all to all.
* **hierarchical** ``('host', 'chip')`` — the multi-host layout made
  explicit (``make_hier_mesh``): rows shard host-major over BOTH axes
  (the linear shard order is ``p = host * chips_per_host + chip``), so
  ring neighbors sit within a host and only the host-boundary pairs
  ``(h, C-1) -> (h+1, 0)`` cross hosts.  Collectives become two-level:

  - halo exchange: one ``ppermute`` over the linearized ``(host, chip)``
    axes — the intra-host pairs stay inside a host and exactly
    ``2*(H-1)`` boundary-pair messages cross hosts (the minimum possible
    for a ring);
  - reductions: chip-level ``psum`` (intra-host) then host-level
    ``psum`` (inter-host) — ``dist_orth.psum_rows``;
  - TSQR: a genuinely two-level R-factor tree — chip-level stacked-R QR
    then host-level — cutting the inter-host reduction volume from
    ``P*m^2`` to ``H*m^2`` (``dist_orth.local_tsqr``).

For multi-host runs, initialize ``jax.distributed`` before building the
mesh (``parallel.runtime.initialize_multihost``); ``make_hier_mesh``
then maps its host axis onto ``jax.process_count()`` by default so the
named topology matches the physical one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

ROWS = "rows"
HOST = "host"
CHIP = "chip"

#: Type of the row-axis handle: the flat mesh's single axis name, or the
#: hierarchical mesh's ``(HOST, CHIP)`` tuple.  Every jax collective
#: (``psum``/``ppermute``/``axis_index``/``axis_size``) and
#: ``PartitionSpec`` accept both forms uniformly, with tuple semantics
#: linearized host-major — exactly the row-shard order.
RowAxes = Union[str, Tuple[str, ...]]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D ``('rows',)`` mesh over the row axis.

    n_devices defaults to all visible devices.  For an explicit host x
    chip hierarchy use :func:`make_hier_mesh`.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                # Silent truncation here would let a "P-way" run execute
                # on fewer shards than requested and every scaling claim
                # downstream would be mislabeled.
                raise ValueError(
                    f"make_mesh({n_devices}): only {len(devices)} "
                    f"device(s) visible ({devices[0].platform}); for CPU "
                    "meshes set XLA_FLAGS=--xla_force_host_platform_"
                    "device_count and jax_platforms='cpu' before first "
                    "device use"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ROWS,))


def make_hier_mesh(
    n_hosts: Optional[int] = None,
    chips_per_host: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """2-D ``('host', 'chip')`` mesh: the hierarchical (intra-host,
    inter-host) topology of a multi-host run made explicit.

    Defaults mirror the physical topology: ``n_hosts = jax.process_count()``
    and ``chips_per_host = local device count``.  ``devices`` must be in
    host-major order (``jax.devices()`` already is — devices of process 0
    first); row shards are laid out host-major so the s-step halo ring
    crosses hosts only at the ``(h, C-1) -> (h+1, 0)`` boundaries.
    """
    if devices is None:
        devices = jax.devices()
        if n_hosts is None:
            n_hosts = max(jax.process_count(), 1)
        if chips_per_host is None:
            chips_per_host = len(devices) // n_hosts
        devices = devices[: n_hosts * chips_per_host]
    else:
        if n_hosts is None or chips_per_host is None:
            raise ValueError("explicit devices require n_hosts and chips_per_host")
    devices = np.asarray(devices)
    if devices.size != n_hosts * chips_per_host:
        raise ValueError(
            f"{devices.size} devices != n_hosts {n_hosts} x chips_per_host "
            f"{chips_per_host}"
        )
    return Mesh(devices.reshape(n_hosts, chips_per_host), (HOST, CHIP))


def row_axes(mesh: Mesh) -> RowAxes:
    """The mesh's row-axis handle for collectives and PartitionSpecs:
    the single axis name on a flat mesh, the ``(HOST, CHIP)``-style tuple
    on a hierarchical one (linearized host-major)."""
    names = mesh.axis_names
    return names[0] if len(names) == 1 else tuple(names)


def row_spec(mesh: Mesh, *, lead_none: int = 0) -> PartitionSpec:
    """PartitionSpec sharding one array dimension over ALL mesh row axes,
    optionally preceded by ``lead_none`` unsharded dimensions (the
    ``(s, n_pad)`` powers-block layout uses ``lead_none=1``)."""
    return PartitionSpec(*([None] * lead_none), row_axes(mesh))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (n, ...) arrays split along rows."""
    return NamedSharding(mesh, row_spec(mesh))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
