"""Command-line harness: ``python -m ca_lanczos_tpu <command>``.

The reference's L4 layer is interactive MATLAB scripts; this CLI exposes
the same experiments as commands writing structured JSONL records.

Commands:
  propagation  — runLanczos.m experiment (std vs CA propagators + oracle)
  sweep        — restarted CA-Lanczos (s, orth) sweep over a matrix set
  info         — corpus metadata (get_matrix_info.m analogue)
  scaling      — weak-scaling sweep of the distributed matrix-powers kernel
  solve        — one-call production eigensolve: .mtx in, eigenvalues out
                 (format routing + driver escalation, harness.solve_auto)
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p):
    p.add_argument("--out", default=None, help="JSONL output path (default stdout)")


def _emit(records, out):
    lines = [r.to_json() if hasattr(r, "to_json") else json.dumps(r) for r in records]
    if out:
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {len(lines)} records to {out}")
    else:
        print("\n".join(lines))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ca_lanczos_tpu")
    ap.add_argument(
        "--platform",
        default="default",
        choices=["cpu", "gpu", "default"],
        help="JAX platform; 'default' keeps the environment's choice "
        "(the GPU when JAX finds one)",
    )
    ap.add_argument("--x64", action="store_true", default=True, help="enable float64")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("propagation", help="harmonic-oscillator propagation experiment")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--dt", type=float, default=0.025)
    p.add_argument("--krylov", type=int, default=24)
    p.add_argument("--s", type=int, default=6)
    p.add_argument("--no-oracle", action="store_true")
    _add_common(p)

    p = sub.add_parser("sweep", help="restarted CA-Lanczos parameter sweep")
    p.add_argument("--mtx", nargs="*", default=[], help=".mtx files (default: synthetic diagonals)")
    p.add_argument("--s", type=int, nargs="*", default=[1, 2, 4, 6, 8, 10])
    p.add_argument("--orth", nargs="*", default=["local", "full", "periodic", "selective"])
    p.add_argument("--max-lanczos", type=int, default=60)
    p.add_argument("--n-wanted", type=int, default=10)
    _add_common(p)

    p = sub.add_parser("info", help="matrix metadata")
    p.add_argument("--mtx", nargs="*", default=[])
    _add_common(p)

    p = sub.add_parser(
        "solve",
        help="route a matrix to a device operator format and solve for "
        "extreme eigenpairs, escalating drivers until converged",
    )
    p.add_argument("--mtx", default=None, help=".mtx file (default: a synthetic spectrum)")
    p.add_argument("--n", type=int, default=2000, help="synthetic matrix size")
    p.add_argument("--cond", type=float, default=1e2, help="synthetic condition number")
    p.add_argument("--n-wanted", type=int, default=10)
    p.add_argument("--which", default="largest",
                   choices=["largest", "smallest"],
                   help="end of the spectrum to target")
    p.add_argument("--s", type=int, default=6)
    p.add_argument("--orth", default="full",
                   choices=["local", "full", "periodic", "selective"])
    p.add_argument("--basis", default="newton", choices=["newton", "monomial"])
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--max-lanczos", type=int, default=60)
    p.add_argument("--max-restarts", type=int, default=200)
    p.add_argument("--prefer", default="auto",
                   choices=["auto", "dense", "dia", "ell"])
    p.add_argument("--no-reorder", action="store_true",
                   help="disable the RCM reorder-and-retry branch")
    p.add_argument("--engine", default="host", choices=["host", "fused"],
                   help="explicit-restart leg: host state machine or the "
                   "one-XLA-call fused driver (single-chip only)")
    p.add_argument("--polish", type=int, default=0, metavar="N",
                   help="two-stage pipeline: N f64 Rayleigh-Ritz polish "
                   "passes on the converged block after the solve "
                   "(device polish for banded f64 sources, host OpenMP "
                   "SpMM otherwise; works on both routes)")
    p.add_argument("--over-lock", type=int, default=0, metavar="K",
                   help="with --polish: lock K extra pairs for the polish "
                   "RR to discard (run the solve at a loose --tol, e.g. "
                   "1e-4, and let the polish set final accuracy)")
    p.add_argument("--cycles-per-call", type=int, default=None,
                   metavar="N",
                   help="fused engine: at most N restart cycles per device "
                   "call (a progress/checkpoint boundary)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="solve row-sharded over an N-device ('rows',) mesh "
        "(parallel.dist_solve_auto; with --platform cpu this forces N "
        "virtual devices, otherwise it uses the first N devices)",
    )
    p.add_argument(
        "--hosts", type=int, default=0, metavar="H",
        help="with --mesh N: use the hierarchical ('host','chip') mesh "
        "with H hosts x N/H chips (inter-host-aware collectives, "
        "parallel.make_hier_mesh) instead of the flat ring",
    )
    _add_common(p)

    p = sub.add_parser("scaling", help="weak-scaling sweep on the local mesh")
    p.add_argument("--devices", type=int, nargs="*", default=None)
    p.add_argument("--rows-per-device", type=int, default=1 << 18)
    p.add_argument("--s", type=int, default=8)
    _add_common(p)

    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import os

    if getattr(args, "mesh", 0) and args.platform == "cpu":
        # Virtual devices must be requested before the CPU backend is
        # instantiated (tests/conftest.py does the same).
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.mesh}"
            ).strip()

    import jax

    from ca_lanczos_tpu.utils.cache import enable_compile_cache

    if args.platform != "default":
        jax.config.update("jax_platforms", args.platform)
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    if args.cmd == "propagation":
        from ca_lanczos_tpu.harness import run_propagation_experiment

        recs = run_propagation_experiment(
            n=args.n, dt=args.dt, n_steps=args.steps, krylov_dim=args.krylov,
            s=args.s, oracle=not args.no_oracle,
        )
        _emit(recs, args.out)

    elif args.cmd == "sweep":
        import numpy as np

        from ca_lanczos_tpu.harness import run_restart_sweep
        from ca_lanczos_tpu.utils.matrices import diag_spectrum
        from ca_lanczos_tpu.utils.mmio import load_operator

        if args.mtx:
            mats = {path: load_operator(path) for path in args.mtx}
            oracles = None
        else:
            mats = {
                "diag_1e2": diag_spectrum(1000, 1.0, 1e2),
                "diag_1e4": diag_spectrum(1000, 1.0, 1e4),
            }
            oracles = {
                "diag_1e2": np.linspace(1.0, 1e2, 1000),
                "diag_1e4": np.linspace(1.0, 1e4, 1000),
            }
        recs = run_restart_sweep(
            mats, s_values=args.s, orths=args.orth,
            max_lanczos=args.max_lanczos, n_wanted=args.n_wanted, oracles=oracles,
        )
        _emit(recs, args.out)

    elif args.cmd == "info":
        from ca_lanczos_tpu.harness import matrix_info
        from ca_lanczos_tpu.utils.matrices import diag_spectrum
        from ca_lanczos_tpu.utils.mmio import load_operator

        if args.mtx:
            recs = [matrix_info(load_operator(p2), p2) for p2 in args.mtx]
        else:
            recs = [matrix_info(diag_spectrum(1000, 1.0, 1e2), "diag_1e2")]
        _emit(recs, args.out)

    elif args.cmd == "solve":
        import numpy as np
        import scipy.sparse as sp

        from ca_lanczos_tpu.config import Basis, LanczosConfig, Orth
        from ca_lanczos_tpu.harness.auto import solve_auto

        if args.mtx:
            from ca_lanczos_tpu.utils.mmio import load_mtx

            ri, ci, vi, (rows, cols) = load_mtx(args.mtx)
            if rows != cols:
                raise SystemExit(f"{args.mtx}: square matrices only")
            a = sp.csr_matrix((vi, (ri, ci)), shape=(rows, cols))
            name = args.mtx
        else:
            d = np.linspace(1.0, args.cond, args.n)
            a = sp.diags(d).tocsr()
            name = f"synthetic diag n={args.n} cond={args.cond:g}"
        cfg = LanczosConfig(
            n_wanted=args.n_wanted, s=args.s,
            orth=Orth[args.orth.upper()], basis=Basis[args.basis.upper()],
            tol=args.tol, max_restarts=args.max_restarts,
        )
        rng = np.random.default_rng(args.seed)
        if args.mesh:
            from ca_lanczos_tpu.parallel import make_mesh
            from ca_lanczos_tpu.parallel.auto import dist_solve_auto

            if args.prefer != "auto":
                print(
                    "warning: --prefer applies to the single-device route "
                    "only; the distributed route picks its own format "
                    "(see parallel.route_dist_operator)",
                    file=sys.stderr,
                )
            if args.hosts:
                from ca_lanczos_tpu.parallel import make_hier_mesh

                if args.mesh % args.hosts:
                    raise SystemExit(
                        f"--hosts {args.hosts} must divide --mesh {args.mesh}"
                    )
                mesh = make_hier_mesh(args.hosts, args.mesh // args.hosts)
            else:
                mesh = make_mesh(args.mesh)
            if mesh.devices.size != args.mesh:
                raise SystemExit(
                    f"--mesh {args.mesh}: only {mesh.devices.size} devices "
                    "available (check XLA_FLAGS / device count)"
                )
            res = dist_solve_auto(
                a, rng.standard_normal(a.shape[0]), args.max_lanczos,
                mesh, cfg, which=args.which,
                polish=args.polish, over_lock=args.over_lock,
                allow_reorder=not args.no_reorder,
            )
        else:
            res = solve_auto(
                a, rng.standard_normal(a.shape[0]), args.max_lanczos, cfg,
                prefer=args.prefer, which=args.which, engine=args.engine,
                cycles_per_call=args.cycles_per_call,
                polish=args.polish, over_lock=args.over_lock,
                allow_reorder=not args.no_reorder,
            )
        rec = {
            "matrix": name,
            "n": int(a.shape[0]),
            "nnz": int(a.nnz),
            "format": res.route.format if res.route else None,
            "reordered": bool(res.route and res.route.perm is not None),
            "route_notes": res.route.notes if res.route else [],
            "solver": res.solver,
            "escalated": res.escalated,
            "converged": res.converged,
            "n_restarts": res.n_restarts,
            "eigs": [float(v) for v in np.sort(np.asarray(res.eigs))[::-1]],
        }
        _emit([rec], args.out)

    elif args.cmd == "scaling":
        import jax

        from ca_lanczos_tpu.parallel.runtime import scaling_sweep

        counts = args.devices or [1, len(jax.devices())]
        recs = scaling_sweep(counts, rows_per_device=args.rows_per_device, s=args.s)
        _emit(recs, args.out)

    return 0


if __name__ == "__main__":
    sys.exit(main())
