"""Distributed one-call eigensolve: raw matrix -> routed dist drivers.

The single-chip production entry (harness.auto.solve_auto) routes any
scipy matrix to the fastest operator format and escalates between the
explicit-restart and implicitly-restarted drivers; this module is its
multi-chip counterpart over a ``('rows',)`` mesh.  Routing differs from
the single-chip case because the distributed operators are row-sharded
with s-deep matrix halos (parallel.distributed:1-19): the halo design
requires BOUNDED column spread (|col - row| <= bw with s*bw < rows per
shard), so the route is

  1. diagonal-sparse      -> DistDia   (shifted-slice local step)
  2. bounded bandwidth    -> DistEll   (XLA gather local step)
  3. unbounded spread     -> RCM reorder, then 1-2 on the permuted
                             matrix (route.perm carries the decode)

Reference seam: the corpus harness drives one solver over arbitrary
SuiteSparse sparsity (test_restarted_ca_lanczos_all_matrices.m:6-14,59);
the MATLAB reference has no distribution layer at all.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ca_lanczos_tpu.config import LanczosConfig
from ca_lanczos_tpu.harness.auto import AutoResult
from ca_lanczos_tpu.ops.formats import OperatorRoute, dia_from_scipy
from ca_lanczos_tpu.ops.spmv import EllMatrix


def route_dist_operator(
    a,
    mesh,
    s_max: int,
    *,
    max_diags: int = 64,
    dia_waste_cap: float = 8.0,
    allow_reorder: bool = True,
    dtype=None,
) -> Tuple[object, OperatorRoute]:
    """Route a square scipy/dense matrix for row-sharded distribution.

    Returns (host_operator, route): the host DiaMatrix or EllMatrix to
    hand a dist driver and the OperatorRoute (perm is None unless RCM
    fired).  ``dtype`` is the operator's storage dtype, as in
    ops.formats.make_operator.

    Feasibility rule: the halo design needs s_max * bandwidth < rows
    per shard; matrices violating it are RCM-reordered, and a matrix
    neither form can host raises ValueError.
    """
    import scipy.sparse as sp

    P_ = int(mesh.devices.size)
    csr = sp.csr_matrix(a) if sp.issparse(a) else sp.csr_matrix(np.asarray(a))
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("square matrices only")
    csr.sum_duplicates()
    csr.sort_indices()
    if dtype is not None:
        csr = csr.astype(dtype)
    n = csr.shape[0]
    nnz = int(csr.nnz)
    n_local = -(-n // P_)
    notes = []

    def _try(csr_x):
        # device=False: the dist partitioners re-slice these planes on
        # the host, so the whole operator never lands on one device.
        coo = csr_x.tocoo()
        bw = int(np.max(np.abs(coo.row - coo.col))) if nnz else 0
        if s_max * bw >= n_local:
            return None, "", bw
        A = dia_from_scipy(
            csr_x, max_diags=max_diags, waste_cap=dia_waste_cap, device=False
        )
        if A is not None:
            return A, "dia", bw
        return EllMatrix.from_scipy(csr_x), "ell", bw

    A, fmt, bw0 = _try(csr)
    if A is not None:
        notes.append(f"bandwidth {bw0} fits {P_}-shard halo (s_max={s_max})")
        return A, OperatorRoute(fmt, None, notes, nnz, bw0, bw0)
    if not allow_reorder:
        raise ValueError(
            f"bandwidth {bw0}: s_max*bw >= {n_local} rows/shard and "
            "reordering is disabled"
        )
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = np.asarray(reverse_cuthill_mckee(csr, symmetric_mode=True))
    csr_p = csr[perm][:, perm].tocsr()
    csr_p.sort_indices()
    A, fmt, bw1 = _try(csr_p)
    notes.append(f"rcm: bandwidth {bw0} -> {bw1}")
    if A is None:
        raise ValueError(
            f"matrix cannot be row-sharded over {P_} devices: RCM "
            f"bandwidth {bw1} still needs halo {s_max * bw1} >= "
            f"{n_local} rows/shard (lower s, use fewer shards, or run "
            "the single-chip route)"
        )
    return A, OperatorRoute(fmt, perm, notes, nnz, bw0, bw1)


def dist_solve_auto(
    a,
    r,
    max_lanczos: int,
    mesh,
    cfg: Optional[LanczosConfig] = None,
    probe_steps: int = 40,
    which: str = "largest",
    polish: int = 0,
    over_lock: int = 0,
    polish_depth: int = 4,
    **route_kwargs,
) -> AutoResult:
    """Multi-chip solve_auto: route ``a`` for distribution, probe the
    spectrum to ORDER the drivers (recommend_solver — same prior as the
    host entry: clustered tops go implicit-first), run the first choice,
    escalate to the other when unconverged at the budget (same contract
    as harness.auto.solve_auto; Q_conv decoded through any RCM perm).

    polish/over_lock: the two-stage pipeline (harness.auto.solve_auto)
    — the gathered converged block is polished against the raw f64
    matrix after the distributed solve."""
    import dataclasses as _dc

    from ca_lanczos_tpu.harness.matrix_info import recommend_solver
    from ca_lanczos_tpu.parallel.dist_irl import dist_impl_restarted_ca_lanczos
    from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

    cfg = cfg or LanczosConfig()
    route = None
    raw = None
    if not hasattr(a, "matvec"):
        raw = a
        a, route = route_dist_operator(
            a, mesh, cfg.s, **route_kwargs
        )
        r = route.apply(r)
    if (polish > 0 or over_lock > 0) and raw is None:
        raise ValueError(
            "polish/over_lock need an f64 operator source: pass the raw "
            "scipy matrix to dist_solve_auto"
        )
    n_want0 = cfg.n_wanted
    if over_lock:
        cfg = _dc.replace(cfg, n_wanted=cfg.n_wanted + over_lock)
    if which not in ("largest", "smallest"):
        raise ValueError(f"which must be 'largest' or 'smallest', got {which!r}")
    if which == "smallest":
        from ca_lanczos_tpu.ops.formats import negate_operator

        a = negate_operator(a)

    def _run(name, c, m=None):
        # c is the attempt's (possibly rescue-leg) config; the dist IRL
        # driver has no orth knob (its inner iteration is always fully
        # reorthogonalized against the window), so only s/budget vary.
        # m: the rung's basis-budget override (the m=96 closer rung).
        budget = m or max_lanczos
        if name == "restarted_ca_lanczos":
            return dist_restarted_ca_lanczos(a, r, budget, mesh, c)
        return dist_impl_restarted_ca_lanczos(
            a, r, budget, mesh,
            n_wanted=c.n_wanted, s=c.s, basis=c.basis,
            tol=c.tol, max_restarts=c.max_restarts,
            mixed_precision=bool(c.orth_params.mixed_precision),
        )

    rec = recommend_solver(a, n_wanted=cfg.n_wanted, probe_steps=probe_steps)
    first = rec["driver"]
    second = (
        "impl_restarted_ca_lanczos"
        if first == "restarted_ca_lanczos"
        else "restarted_ca_lanczos"
    )
    from ca_lanczos_tpu.harness.auto import _escalate, _ladder

    res, solver, escalated = _escalate(
        _run, _ladder(cfg, first, second, max_lanczos)
    )
    solver = "dist_" + solver
    Q = res.Q_conv
    if route is not None and route.perm is not None and Q is not None:
        Q = route.restore(Q)
    eigs = np.asarray(res.eigs)
    presid = None
    if polish > 0 and Q is not None and np.asarray(Q).shape[1] > 0:
        from ca_lanczos_tpu.harness.auto import _polish_block

        w, presid, Qp = _polish_block(
            raw, None, route, np.asarray(Q), which, polish, polish_depth
        )
        keep = min(n_want0, len(w))
        eigs, presid = w[:keep], presid[:keep]
        Q = Qp[:, :keep] if Qp is not None else None
        solver = solver + f"+polish{polish}"
    if which == "smallest":
        eigs = -eigs
    return AutoResult(
        eigs=eigs,
        Q_conv=Q,
        converged=bool(res.converged),
        n_restarts=int(res.n_restarts),
        solver=solver,
        escalated=escalated,
        route=route,
        polish_resid=presid,
    )
