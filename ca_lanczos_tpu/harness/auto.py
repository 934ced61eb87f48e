"""Escalation-routed eigensolve: the production "just solve it" entry.

The round-2 corpus campaign (results/corpus_sweep.jsonl) showed that no
cheap spectral probe reliably PREDICTS which corpus families defeat the
explicit-restart flagship at the reference budget (clustered-top
families like stiff_1d have probe-invisible 1e-5 gaps, while exactly
degenerate mesh spectra converge fine) — so instead of predicting,
``solve_auto`` guarantees by escalation: run the driver the probe
prefers first, and if it returns unconverged at the budget, walk the
rest of the ladder at the SAME budget — the other driver (explicit
thick restart <-> implicitly-restarted with locking), then the
numerically-safe rescue rungs (full reorthogonalization at the case's
s; s=4 full-orth for both drivers) that close the s-step Newton-basis
conditioning failures (see ``_ladder``).  The round-3 corpus campaign
converges 552/552 through this ladder (results/corpus_summary.json,
CPU runs).  The probe
(``recommend_solver``) only chooses the ORDER, saving the first solve
on clearly clustered spectra.

Reference seam: test_restarted_ca_lanczos_all_matrices.m:59 drives one
solver over the corpus and reports failures; this module is the
framework's answer for making the whole corpus converge unattended.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from ca_lanczos_tpu.config import LanczosConfig
from ca_lanczos_tpu.harness.matrix_info import recommend_solver


@dataclasses.dataclass
class AutoResult:
    eigs: np.ndarray
    Q_conv: Optional[jax.Array]
    converged: bool
    n_restarts: int
    solver: str  # driver that produced the result
    escalated: bool  # True when the first-choice driver failed
    route: Optional[object] = None  # OperatorRoute when A was raw input
    # true absolute residuals ||A x - w x|| after the f64 polish
    # (None when polish=0); aligned with eigs
    polish_resid: Optional[np.ndarray] = None


def _n_locked(res) -> int:
    """Number of genuinely locked eigenvalues in a driver result.

    Host drivers return only converged eigenvalues; the fused driver
    NaN-pads eigs to fixed n_wanted length, so a raw len() comparison
    between legs is meaningless — count finite entries."""
    e = np.atleast_1d(np.asarray(res.eigs, np.float64))
    return int(np.sum(np.isfinite(e)))


_M_LARGE = 96  # larger-basis rescue rung (see _ladder)


def _ladder(cfg: LanczosConfig, first: str, second: str,
            max_lanczos: Optional[int] = None):
    """Escalation ladder: the two probe-ordered drivers at the case's own
    config, then numerically-SAFE rescue legs for the failure physics the
    round-2 corpus campaign left open (the s=10 Newton basis condition
    number exceeds f64 on kappa~1e8 spectra, and weak orth modes lose
    the clustered partners; ROADMAP.md "Findings kept") — full
    reorthogonalization at
    the case's s, then the s=4 full-orth CA-safe regime for both drivers.
    The budget (max_basis vectors per cycle, max_restarts) never grows on
    these rungs.

    Final rung (round-5, the mesh_2d_aniso closer): when the caller's
    per-cycle basis budget is below ``_M_LARGE``, one IRL full-orth
    attempt at m=96.  Near-degenerate tops (1e-6-relative gaps at
    eps=1e-3 anisotropy) are unresolvable in a 60-vector window at any
    orth setting — the restart polynomial cannot separate the cluster —
    but a 96-vector window converges them in ~100 implicit restarts
    (measured: err 1.5e-12 where every 60-vector leg stalls at 4.9e-6).
    The larger budget is explicit in the label so results stay
    auditable against the reference-budget legs.

    Returns [(driver, cfg, label, m_override), ...]; m_override=None
    keeps the caller's budget."""
    from ca_lanczos_tpu.config import Orth

    attempts = [(first, cfg, first, None), (second, cfg, second, None)]
    if cfg.orth != Orth.FULL:
        c = dataclasses.replace(cfg, orth=Orth.FULL)
        attempts.append(
            ("impl_restarted_ca_lanczos", c,
             "impl_restarted_ca_lanczos[orth=full]", None)
        )
    if cfg.s > 4:
        c4 = dataclasses.replace(cfg, s=4, orth=Orth.FULL)
        attempts.append(
            ("impl_restarted_ca_lanczos", c4,
             "impl_restarted_ca_lanczos[s=4,orth=full]", None)
        )
        attempts.append(
            ("restarted_ca_lanczos", c4,
             "restarted_ca_lanczos[s=4,orth=full]", None)
        )
    if max_lanczos is not None and max_lanczos < _M_LARGE:
        cf = dataclasses.replace(cfg, orth=Orth.FULL)
        attempts.append(
            ("impl_restarted_ca_lanczos", cf,
             f"impl_restarted_ca_lanczos[orth=full,m={_M_LARGE}]",
             _M_LARGE)
        )
    return attempts


def _escalate(run, attempts):
    """Shared escalation policy for the single- and multi-chip entries:
    walk the ladder until a driver converges; otherwise keep the attempt
    that locked the most (finite) pairs.  ``run(name, cfg, m_override)``
    returns the driver result.  Returns (result, label, escalated)."""
    best = best_label = None
    best_i = 0
    for i, (name, c, label, m) in enumerate(attempts):
        res = run(name, c, m)
        if res.converged:
            return res, label, i > 0
        if best is None or _n_locked(res) > _n_locked(best):
            best, best_label, best_i = res, label, i
    return best, best_label, best_i > 0


def _run(solver: str, A, r, max_lanczos: int, cfg: LanczosConfig,
         engine: str = "host", cycles_per_call=None):
    if solver == "restarted_ca_lanczos":
        if engine == "fused":
            from ca_lanczos_tpu.solvers.fused_restarted import (
                fused_restarted_ca_lanczos,
            )

            return fused_restarted_ca_lanczos(
                A, r, max_lanczos,
                n_wanted=cfg.n_wanted, s=cfg.s, basis=cfg.basis,
                tol=cfg.tol, max_restarts=cfg.max_restarts,
                mixed_precision=cfg.orth_params.mixed_precision,
                cycles_per_call=cycles_per_call,
            )
        from ca_lanczos_tpu.solvers.restarted import restarted_ca_lanczos

        return restarted_ca_lanczos(A, r, max_lanczos, cfg)
    from ca_lanczos_tpu.solvers.implicitly_restarted import (
        impl_restarted_ca_lanczos,
    )

    return impl_restarted_ca_lanczos(
        A, r, max_lanczos,
        n_wanted=cfg.n_wanted, s=cfg.s, basis=cfg.basis, orth=cfg.orth,
        tol=cfg.tol, max_restarts=cfg.max_restarts,
    )


def solve_auto(
    A,
    r,
    max_lanczos: int,
    cfg: Optional[LanczosConfig] = None,
    probe_steps: int = 40,
    engine: str = "host",
    which: str = "largest",
    cycles_per_call: Optional[int] = None,
    polish: int = 0,
    over_lock: int = 0,
    polish_depth: int = 4,
    **route_kwargs,
) -> AutoResult:
    """Solve for ``cfg.n_wanted`` extreme eigenpairs, escalating between
    the explicit-restart and implicitly-restarted drivers until one
    converges (see module docstring).  Both drivers see the same budget
    (``max_lanczos`` basis vectors per cycle, ``cfg.max_restarts``).

    ``A`` may be a framework Operator, OR any square scipy.sparse /
    dense matrix — raw input is routed to a device operator format via
    ``ops.formats.make_operator`` (``route_kwargs`` forwarded, e.g.
    ``prefer`` or ``dtype=np.float32`` for an f32 solve of an f64
    matrix that stays the polish's f64 source); when the
    route reorders, ``r`` is encoded and ``Q_conv`` decoded here, so the
    caller never sees the permutation (result.route records it).

    ``engine="fused"`` runs the explicit-restart leg as the one-XLA-call
    ``fused_restarted_ca_lanczos`` (mixed precision per
    ``cfg.orth_params.mixed_precision``); the IRL escalation leg stays
    on the host driver either way.  ``cycles_per_call`` bounds each
    fused device call to that many restart cycles (a progress and
    checkpoint boundary).

    ``which="smallest"`` targets the other end of the spectrum by
    solving -A and negating the eigenvalues back
    (ops.formats.negate_operator).

    ``polish`` > 0 runs that many f64 block-Krylov Rayleigh-Ritz passes
    on the converged block after the solve (solvers.polish) — on DEVICE
    when the operator is DIA-representable from the raw f64 input, on
    host (native OpenMP CSR SpMM) otherwise; residuals return in
    ``AutoResult.polish_resid``.  ``over_lock`` locks that many EXTRA
    pairs during the solve so the polish RR can discard sloppy
    directions and still return ``cfg.n_wanted`` accurate pairs — the
    two-stage pipeline (a loose-tol pure-f32 solve + polish=10,
    over_lock=3).  Applicability: separated or moderately clustered
    tops; tightly clustered tops should keep the standard tolerance
    (the polish still helps, never hurts)."""
    import jax.numpy as jnp

    cfg = cfg or LanczosConfig()
    route = None
    raw = None  # the caller's raw matrix (the f64 source for the polish)
    # framework operators are duck-typed on .matvec
    if not hasattr(A, "matvec"):
        from ca_lanczos_tpu.ops.formats import make_operator

        raw = A
        A, route = make_operator(A, **route_kwargs)
        r = jnp.asarray(route.apply(r), A.dtype)
    if polish > 0 or over_lock > 0:
        from ca_lanczos_tpu.ops.spmv import DiaMatrix

        if raw is None and not isinstance(A, DiaMatrix):
            raise ValueError(
                "polish/over_lock need an f64 operator source: pass the "
                "raw scipy matrix to solve_auto, or a DiaMatrix operator"
            )
    n_want0 = cfg.n_wanted
    if over_lock:
        cfg = dataclasses.replace(cfg, n_wanted=cfg.n_wanted + over_lock)
    if which not in ("largest", "smallest"):
        raise ValueError(f"which must be 'largest' or 'smallest', got {which!r}")
    if which == "smallest":
        from ca_lanczos_tpu.ops.formats import negate_operator

        A = negate_operator(A)
    rec = recommend_solver(A, n_wanted=cfg.n_wanted, probe_steps=probe_steps)
    first = rec["driver"]
    second = (
        "impl_restarted_ca_lanczos"
        if first == "restarted_ca_lanczos"
        else "restarted_ca_lanczos"
    )
    res, solver, escalated = _escalate(
        lambda name, c, m: _run(name, A, r, m or max_lanczos, c, engine,
                                cycles_per_call),
        _ladder(cfg, first, second, max_lanczos),
    )
    Q = res.Q_conv
    if route is not None and route.perm is not None and Q is not None:
        Q = route.restore(Q)
    eigs = np.asarray(res.eigs)
    presid = None
    if polish > 0 and Q is not None and Q.shape[1] > 0:
        # Polish in the ORIGINAL frame (after any route restore) against
        # the f64 source; the solve frame's negation (which="smallest")
        # is re-applied so the RR keeps the wanted end.
        w, presid, Qp = _polish_block(
            raw, A, route, Q, which, polish, polish_depth
        )
        keep = min(n_want0, len(w))
        eigs, presid = w[:keep], presid[:keep]
        Q = Qp[:, :keep] if Qp is not None else None
        if which == "smallest":
            eigs = -eigs
        return AutoResult(
            eigs=eigs,
            Q_conv=Q,
            converged=bool(res.converged),
            n_restarts=int(res.n_restarts),
            solver=solver + f"+polish{polish}",
            escalated=escalated,
            route=route,
            polish_resid=presid,
        )
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
    )


def _polish_block(raw, A_solve, route, Q, which, iters: int, depth: int):
    """f64 Rayleigh-Ritz polish of a converged block in the caller's
    frame: device path for DIA-representable f64 sources, host path
    (native OpenMP CSR SpMM) otherwise.  Returns (w desc-in-solve-frame,
    resid, Q (n, k)) — w/resid aligned with Q's columns."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from ca_lanczos_tpu.ops.spmv import DiaMatrix
    from ca_lanczos_tpu.solvers.polish import (
        rayleigh_ritz_polish, rayleigh_ritz_polish_host,
    )

    sgn = -1.0 if which == "smallest" else 1.0
    if raw is not None and (route is None or route.perm is None):
        coo = sp.coo_matrix(raw)
        # Count distinct diagonals BEFORE any dia conversion:
        # sp.dia_matrix materializes (n_offsets, n) data, which for
        # scattered sparsity is O(n^2) memory.
        offsets = np.unique(coo.col.astype(np.int64) - coo.row)
        if len(offsets) <= 48:  # DIA-representable: device polish
            d = sp.dia_matrix(sp.csr_matrix(raw).astype(np.float64))
            A64 = DiaMatrix(
                data=jnp.asarray(sgn * _dia_rows(d)),
                offsets=tuple(int(o) for o in d.offsets),
            )
            w, resid, Qp = rayleigh_ritz_polish(
                A64, jnp.asarray(Q, jnp.float32), iters=iters, depth=depth
            )
            return w, resid, np.asarray(Qp)
    if raw is None and isinstance(A_solve, DiaMatrix):
        # Framework DIA input: polish against its planes upcast to f64
        # (representation-limited if they were stored f32 — documented).
        A64 = DiaMatrix(
            data=jnp.asarray(np.asarray(A_solve.data), jnp.float64),
            offsets=A_solve.offsets,
        )  # A_solve is already negated for which="smallest"
        w, resid, Qp = rayleigh_ritz_polish(
            A64, jnp.asarray(Q, jnp.float32), iters=iters, depth=depth
        )
        return w, resid, np.asarray(Qp)
    # Host path: general sparsity (or permuted routes) against the raw
    # f64 matrix via the native OpenMP SpMM.
    from ca_lanczos_tpu.ops._spmm_native import CsrMatmul

    mm = CsrMatmul(sp.csr_matrix(raw).astype(np.float64))
    mv = (lambda Z: -mm(Z)) if sgn < 0 else mm
    w, resid, Qp = rayleigh_ritz_polish_host(
        mv, np.asarray(Q), iters=iters, depth=depth
    )
    return w, resid, Qp


def _dia_rows(d) -> np.ndarray:
    """scipy dia_matrix data -> ops.spmv DiaMatrix row convention
    (A[i, i+k] = data[row_of_k, i]; scipy stores A[i, i+k] at
    data[row_of_k, i+k])."""
    n = d.shape[0]
    out = np.zeros((len(d.offsets), n), np.float64)
    for j, k in enumerate(d.offsets):
        if k >= 0:
            out[j, : n - k] = d.data[j, k:n]
        else:
            out[j, -k:] = d.data[j, : n + k]
    return out
