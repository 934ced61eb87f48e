"""On-card smoke test of the eigensolver's main path.

    python chip_smoke.py          # one GPU: phases 1-3 below
    python chip_smoke.py --four   # four GPUs: the distributed flagship only

Phases (each prints one line; any failure fails the script):

1. Banded flagship end to end: the 11,010,048-row tridiagonal operator
   (f32 planes) through ``harness.solve_auto`` with the two-stage
   settings (loose f32 solve, ``polish=10, over_lock=3``), against the
   committed f64 oracle ``exp/flagship_10m_oracle_11010048.npz``.
2. General sparsity end to end: the 11,010,048-row random-banded
   operator routed to ELL and solved in f64 through ``solve_auto``,
   against ``exp/pell_10m_oracle_11010048.npz``.
3. Plain XLA kernels at real widths: f32 matrix powers (monomial and
   Newton, s=8) on a 2^23-row 9-diagonal DIA operator against a float64
   scipy SpMV chain, f32 CholQR2 of a 2^23 x 9 block, and the scan's
   Gnnz/s next to a device copy of the same bytes.

``--four`` runs ``parallel.dist_solve_auto`` on ``make_mesh(4)`` on the
phase-1 operator against the same oracle and tolerances, and nothing
else.  The last line of stdout is the JSON ok record; the script exits
non-zero and prints no such line when JAX finds no GPU or a phase fails.
"""

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import scipy.sparse as sp

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FLAGSHIP = 10 * (1 << 20) + (1 << 19)  # 11,010,048 rows
N_KERNEL = 1 << 23


def flagship_matrix(n: int) -> sp.csr_matrix:
    """The banded flagship: planted top-10 spectrum (95..100 over a
    1..90 bulk) with 1e-3 random off-diagonal coupling, f64 CSR."""
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = np.linspace(95.0, 100.0, 10)
    rng = np.random.default_rng(0)
    off = rng.standard_normal(n) * 1e-3
    return sp.diags([off[:-1], d, off[:-1]], [-1, 0, 1], format="csr")


def random_banded_matrix(n: int, bw: int = 8, k: int = 4, seed: int = 0):
    """General sparsity: k random columns per row inside a width-bw band,
    symmetrized, over the same planted spectrum (f64 CSR)."""
    rng = np.random.default_rng(seed)
    d = np.linspace(1.0, 90.0, n)
    d[-10:] = np.linspace(95.0, 100.0, 10)
    rows = np.repeat(np.arange(n), k)
    keys = rng.random((n, 2 * bw + 1))
    pick = np.argsort(keys, axis=1)[:, :k]  # k distinct offsets in [-bw, bw]
    cols = np.arange(n)[:, None] + (pick - bw)
    cols = np.clip(cols, 0, n - 1).ravel()
    vals = (rng.standard_normal(n * k) * 1e-3).ravel()
    off = sp.csr_matrix((vals, (rows, cols)), (n, n))
    a = off + off.T + sp.diags(d)
    a.sum_duplicates()
    return a.tocsr()


def oracle(name: str, n: int) -> np.ndarray:
    """Top-10 f64 eigenvalues (descending) of the committed oracle."""
    return np.load(os.path.join(ROOT, "exp", f"{name}_oracle_{n}.npz"))["exact"]


def _flagship_check(res, a, exact, n_pairs: int = 10):
    """(max relative eigenvalue error, max relative true residual) of the
    top ``n_pairs`` against the oracle; ||A|| = exact[0]."""
    norm_a = float(exact[0])
    order = np.argsort(res.eigs)[::-1][:n_pairs]
    eigs = np.asarray(res.eigs)[order]
    Q = np.asarray(res.Q_conv, np.float64)[:, order]
    resid = np.linalg.norm(a @ Q - Q * eigs[None, :], axis=0) / np.linalg.norm(Q, axis=0)
    return float(np.max(np.abs(eigs - exact[:n_pairs])) / norm_a), float(np.max(resid) / norm_a)


def two_stage_config():
    from ca_lanczos_tpu.config import Basis, LanczosConfig

    # Loose first stage: the f32 solve only has to span the wanted
    # directions; the f64 polish sets the final accuracy.
    return LanczosConfig(n_wanted=10, s=8, basis=Basis.NEWTON, tol=1e-4,
                         max_restarts=200)


def phase_flagship(n: int, exact: np.ndarray):
    from ca_lanczos_tpu.harness.auto import solve_auto

    a = flagship_matrix(n)
    r = np.ones(n)
    walls = []
    for _ in range(2):  # cold (compiles), then warm
        t0 = time.perf_counter()
        res = solve_auto(a, r, 32, two_stage_config(), engine="fused",
                         polish=10, over_lock=3, dtype=np.float32)
        walls.append(time.perf_counter() - t0)
    eig_err, resid = _flagship_check(res, a, exact)
    ok = bool(res.converged) and eig_err <= 1e-9 and resid <= 1e-8
    return ok, (
        f"phase1 flagship n={n} format={res.route.format} solver={res.solver} "
        f"converged={res.converged} restarts={res.n_restarts} "
        f"cold_s={walls[0]:.2f} warm_s={walls[1]:.2f} "
        f"max_rel_eig_err={eig_err:.3e} (<=1e-9) "
        f"max_rel_resid={resid:.3e} (<=1e-8) ok={ok}"
    )


def phase_general(n: int, exact: np.ndarray):
    from ca_lanczos_tpu.config import Basis, LanczosConfig
    from ca_lanczos_tpu.harness.auto import solve_auto

    t0 = time.perf_counter()
    a = random_banded_matrix(n)
    build = time.perf_counter() - t0
    cfg = LanczosConfig(n_wanted=10, s=8, basis=Basis.NEWTON, tol=1e-9,
                        max_restarts=200)
    t0 = time.perf_counter()
    res = solve_auto(a, np.ones(n), 32, cfg, engine="fused", prefer="ell")
    wall = time.perf_counter() - t0
    eig_err, resid = _flagship_check(res, a, exact)
    ok = bool(res.converged) and eig_err <= 1e-8
    return ok, (
        f"phase2 general n={n} nnz={a.nnz} format={res.route.format} "
        f"solver={res.solver} converged={res.converged} "
        f"restarts={res.n_restarts} build_s={build:.2f} wall_s={wall:.2f} "
        f"max_rel_eig_err={eig_err:.3e} (<=1e-8) max_rel_resid={resid:.3e} "
        f"polish=off (f64 ELL solve; the general-sparsity polish is host "
        f"SpMM) ok={ok}"
    )


def kernel_operator(n: int):
    """9-diagonal f32 DIA operator with spectral radius < 1 (so chained
    powers stay bounded) and the same planes as a float64 scipy CSR."""
    import jax.numpy as jnp

    from ca_lanczos_tpu.ops.spmv import DiaMatrix

    offsets = tuple(range(-4, 5))
    rng = np.random.default_rng(0)
    data = np.asarray(rng.standard_normal((len(offsets), n)), np.float32) * 0.02
    data[len(offsets) // 2] += 0.8
    # scipy dia stores A[j - o, j] at column j; DiaMatrix stores A[i, i + o]
    # at row i.
    sdata = np.zeros(data.shape, np.float64)
    for k, o in enumerate(offsets):
        if o >= 0:
            sdata[k, o:] = data[k, : n - o]
        else:
            sdata[k, : n + o] = data[k, -o:]
    ref = sp.dia_matrix((sdata, offsets), shape=(n, n)).tocsr()
    return DiaMatrix(data=jnp.asarray(data), offsets=offsets), ref


def phase_kernels(n: int, device_kind: str):
    import jax
    import jax.numpy as jnp

    from ca_lanczos_tpu.basis.newton import newton_basis_matrix
    from ca_lanczos_tpu.config import Basis
    from ca_lanczos_tpu.ops.matrix_powers import matrix_powers
    from ca_lanczos_tpu.ops.qr import cholqr2
    from ca_lanczos_tpu.solvers.ca_lanczos import monomial_basis_matrix
    from ca_lanczos_tpu.utils.profiling import (
        measure_copy_bandwidth, measure_powers_throughput, peak_hbm_bw,
        roofline_audit,
    )

    s = 8
    A, ref = kernel_operator(n)
    rng = np.random.default_rng(1)
    q = rng.standard_normal(n).astype(np.float32)
    q /= np.linalg.norm(q)
    errs = {}
    shifts = np.linspace(-0.5, 0.5, s)  # real Newton shifts off the spectrum
    for name, basis, B in (
        ("monomial", Basis.MONOMIAL, monomial_basis_matrix(s)),
        ("newton", Basis.NEWTON, newton_basis_matrix(shifts, s)),
    ):
        V = np.asarray(matrix_powers(A, jnp.asarray(q), s, B, basis), np.float64)
        W = np.zeros((n, s + 1))
        W[:, 0] = q
        for k in range(s):
            W[:, k + 1] = ref @ W[:, k] - B[k, k] * W[:, k]
            if k > 0:
                W[:, k + 1] -= B[k - 1, k] * W[:, k - 1]
        errs[name] = float(max(
            np.linalg.norm(V[:, k] - W[:, k]) / np.linalg.norm(W[:, k])
            for k in range(s + 1)
        ))
    X = jnp.asarray(rng.standard_normal((n, 9)).astype(np.float32))
    Q, _ = cholqr2(X)
    Q64 = np.asarray(Q, np.float64)
    orth = float(np.linalg.norm(Q64.T @ Q64 - np.eye(9), 2))
    del X, Q, Q64

    rate = measure_powers_throughput(A, s=s, reps=20, trials=3)
    rep = roofline_audit(A, rate, hbm_bw=peak_hbm_bw(device_kind))
    scan_bw = rate / rep.nnz * rep.bytes_per_step
    copy_bw = measure_copy_bandwidth(A.data)
    jax.block_until_ready(A.data)
    ok = errs["monomial"] <= 1e-5 and errs["newton"] <= 1e-5 and orth <= 1e-5
    return ok, (
        f"phase3 kernels n={n} ndiags=9 s={s} "
        f"powers_rel_err monomial={errs['monomial']:.3e} "
        f"newton={errs['newton']:.3e} (<=1e-5) "
        f"cholqr2_orth={orth:.3e} (<=1e-5) "
        f"xla_scan_gnnz_s={rate / 1e9:.2f} scan_gb_s={scan_bw / 1e9:.1f} "
        f"copy_gb_s={copy_bw / 1e9:.1f} share_of_copy={scan_bw / copy_bw:.3f} "
        f"share_of_peak={rep.fraction_of_peak:.3f} ok={ok}"
    )


def phase_four(n: int, exact: np.ndarray):
    from ca_lanczos_tpu.ops.formats import dia_from_scipy
    from ca_lanczos_tpu.parallel import dist_solve_auto, make_mesh
    from ca_lanczos_tpu.parallel.step import partition_operator

    mesh = make_mesh(4)
    a = flagship_matrix(n)
    cfg = two_stage_config()
    # Shards must land on four distinct cards, not all on device 0.
    Ad = partition_operator(
        dia_from_scipy(a, dtype=np.float32, device=False), mesh, s_max=cfg.s
    )
    shard_devs = sorted({sh.device.id for sh in Ad.data.addressable_shards})
    del Ad
    t0 = time.perf_counter()
    res = dist_solve_auto(a, np.ones(n), 32, mesh, cfg, polish=10,
                          over_lock=3, dtype=np.float32)
    wall = time.perf_counter() - t0
    eig_err, resid = _flagship_check(res, a, exact)
    ok = (len(shard_devs) == 4 and bool(res.converged)
          and eig_err <= 1e-9 and resid <= 1e-8)
    return ok, (
        f"four dist_flagship n={n} mesh=('rows',)x4 shard_devices={shard_devs} "
        f"format={res.route.format} solver={res.solver} "
        f"converged={res.converged} restarts={res.n_restarts} "
        f"wall_s={wall:.2f} max_rel_eig_err={eig_err:.3e} (<=1e-9) "
        f"max_rel_resid={resid:.3e} (<=1e-8) ok={ok}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed flagship on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from ca_lanczos_tpu.utils.cache import enable_compile_cache
    from ca_lanczos_tpu.utils.device import card_info, require_gpu

    devices = require_gpu()
    jax.config.update("jax_enable_x64", True)
    cache_dir = enable_compile_cache()
    kind = devices[0].device_kind
    print(f"jax {jax.__version__} device_kind={kind!r} count={len(devices)}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} compile_cache={cache_dir}")
    for line in card_info():
        print(line)
    sys.stdout.flush()

    if args.four:
        phases = [("four", lambda: phase_four(N_FLAGSHIP, oracle("flagship_10m", N_FLAGSHIP)))]
    else:
        phases = [
            ("phase1", lambda: phase_flagship(N_FLAGSHIP, oracle("flagship_10m", N_FLAGSHIP))),
            ("phase2", lambda: phase_general(N_FLAGSHIP, oracle("pell_10m", N_FLAGSHIP))),
            ("phase3", lambda: phase_kernels(N_KERNEL, kind)),
        ]
    failed = []
    for name, run in phases:
        try:
            ok, line = run()
        except Exception:
            ok, line = False, f"{name} FAILED:\n{traceback.format_exc()}"
        print(line, flush=True)
        if not ok:
            failed.append(name)
        jax.clear_caches()
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
