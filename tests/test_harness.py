"""Harness-layer tests: Matrix Market IO (native + fallback), run
records, matrix info, and the experiment drivers at reduced size."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from ca_lanczos_tpu.harness import (
    matrix_info,
    read_records,
    run_convergence_experiment,
    run_propagation_experiment,
    run_restart_sweep,
    write_records,
)
from ca_lanczos_tpu.ops.spmv import DiaMatrix, EllMatrix
from ca_lanczos_tpu.utils.matrices import diag_spectrum, laplacian_1d
from ca_lanczos_tpu.utils.mmio import _load_mtx_python, load_mtx, load_operator, save_mtx


class TestMmio:
    @pytest.fixture
    def mtx_file(self, tmp_path):
        rng = np.random.default_rng(0)
        a = sp.random(50, 50, density=0.1, random_state=rng.integers(1 << 30))
        a = a + a.T  # symmetric values, stored general
        path = str(tmp_path / "t.mtx")
        save_mtx(path, a)
        return path, a.toarray()

    def test_roundtrip_native(self, mtx_file):
        path, dense = mtx_file
        ri, ci, vi, shape = load_mtx(path)
        got = sp.coo_matrix((vi, (ri, ci)), shape=shape).toarray()
        np.testing.assert_allclose(got, dense, atol=1e-15)

    def test_native_matches_python(self, mtx_file):
        path, _ = mtx_file
        ri, ci, vi, shape = load_mtx(path)
        rp, cp, vp, shapep = _load_mtx_python(path)
        a = sp.coo_matrix((vi, (ri, ci)), shape=shape).toarray()
        b = sp.coo_matrix((vp, (rp, cp)), shape=shapep).toarray()
        np.testing.assert_array_equal(a, b)

    def test_symmetric_storage_expanded(self, tmp_path):
        a = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 0.5], [0.0, 0.5, 4.0]])
        path = str(tmp_path / "sym.mtx")
        save_mtx(path, sp.coo_matrix(a), symmetric=True)
        ri, ci, vi, shape = load_mtx(path)
        got = sp.coo_matrix((vi, (ri, ci)), shape=shape).toarray()
        np.testing.assert_allclose(got, a)

    def test_load_operator_formats(self, tmp_path):
        # Banded -> DIA
        tri = sp.diags([[-1.0] * 39, [2.0] * 40, [-1.0] * 39], [-1, 0, 1])
        p1 = str(tmp_path / "band.mtx")
        save_mtx(p1, tri)
        A = load_operator(p1)
        assert isinstance(A, DiaMatrix)
        np.testing.assert_allclose(np.asarray(A.to_dense()), tri.toarray(), atol=1e-15)
        # Scattered -> ELL
        rng = np.random.default_rng(1)
        scat = sp.random(60, 60, density=0.3, random_state=7)
        p2 = str(tmp_path / "scat.mtx")
        save_mtx(p2, scat)
        B = load_operator(p2)
        assert isinstance(B, EllMatrix)
        np.testing.assert_allclose(np.asarray(B.to_dense()), scat.toarray(), atol=1e-15)


class TestRecords:
    def test_roundtrip(self, tmp_path):
        from ca_lanczos_tpu.harness.records import RunRecord

        recs = [
            RunRecord(matrix="m1", solver="x", s=4, max_eig_err=1e-9, extra={"foo": 1}),
            RunRecord(matrix="m2", solver="y", converged=True),
        ]
        path = str(tmp_path / "r.jsonl")
        write_records(path, recs)
        back = read_records(path)
        assert back[0]["matrix"] == "m1" and back[0]["foo"] == 1
        assert back[1]["converged"] is True
        assert "s" not in back[1]  # None fields dropped


class TestMatrixInfo:
    def test_diag(self):
        A = diag_spectrum(100, 1.0, 10.0)
        info = matrix_info(A, "diag100")
        assert info["n"] == 100
        np.testing.assert_allclose(info["eig_max"], 10.0)
        np.testing.assert_allclose(info["eig_min"], 1.0)
        np.testing.assert_allclose(info["cond"], 10.0)
        np.testing.assert_allclose(info["normest"], 10.0, rtol=1e-3)

    def test_recommend_solver_gapped_vs_clustered(self):
        from ca_lanczos_tpu.harness import recommend_solver
        from ca_lanczos_tpu.ops.spmv import DiaMatrix

        # Well-separated top: explicit restart is the recommendation.
        gapped = diag_spectrum(400, 1.0, 100.0)
        rec = recommend_solver(gapped, n_wanted=5)
        assert rec["driver"] == "restarted_ca_lanczos"
        assert not rec["clustered"]

        # Near-degenerate top cluster: IRL with locking.
        vals = np.concatenate([np.linspace(1.0, 50.0, 392),
                               100.0 + 1e-6 * np.arange(8)])
        clustered = DiaMatrix(data=jnp.asarray(vals)[None, :], offsets=(0,))
        rec = recommend_solver(clustered, n_wanted=5)
        assert rec["driver"] == "impl_restarted_ca_lanczos"
        assert rec["clustered"]

    def test_solve_auto_escalates(self):
        """solve_auto rescues a case the probe routes wrong: a top
        cluster just below probe resolution recommends the explicit
        driver, which stalls; escalation converges it at the same
        budget (module docstring of harness/auto.py)."""
        from ca_lanczos_tpu.config import LanczosConfig, Orth
        from ca_lanczos_tpu.harness import solve_auto
        from ca_lanczos_tpu.ops.spmv import DiaMatrix

        n = 400
        vals = np.concatenate([np.linspace(1.0, 50.0, n - 4),
                               100.0 + 2e-4 * np.arange(4)])
        A = DiaMatrix(data=jnp.asarray(vals)[None, :], offsets=(0,))
        r = jnp.asarray(np.random.default_rng(0).random(n))
        cfg = LanczosConfig(s=4, n_wanted=4, orth=Orth.FULL, tol=1e-9,
                            max_restarts=60)
        res = solve_auto(A, r, 24, cfg)
        assert res.converged
        exact = np.sort(vals)[::-1][:4]
        got = np.sort(res.eigs)[::-1][:4]
        np.testing.assert_allclose(got, exact, rtol=1e-8)

    def test_solve_auto_fast_path(self):
        """A well-separated spectrum stays on the explicit driver with
        no escalation."""
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.harness import solve_auto

        A = diag_spectrum(400, 1.0, 100.0)
        r = jnp.asarray(np.random.default_rng(1).random(400))
        cfg = LanczosConfig(s=4, n_wanted=4, tol=1e-9)
        res = solve_auto(A, r, 32, cfg)
        assert res.converged
        assert res.solver == "restarted_ca_lanczos"
        assert not res.escalated


class TestExperiments:
    def test_propagation_small(self):
        recs = run_propagation_experiment(n=64, n_steps=5, krylov_dim=12, s=3)
        assert len(recs) == 3
        for r in recs:
            assert r.extra["max_abs_err"] < 1e-7
            assert r.wall_s > 0

    def test_restart_sweep_small(self):
        mats = {"diag200": diag_spectrum(200, 1.0, 50.0)}
        oracles = {"diag200": np.linspace(1.0, 50.0, 200)}
        recs = run_restart_sweep(
            mats, s_values=(4,), orths=("local",), max_lanczos=24, n_wanted=4,
            oracles=oracles,
        )
        assert len(recs) == 1
        assert recs[0].converged
        assert recs[0].max_eig_err < 1e-5

    def test_convergence_traces(self):
        A = diag_spectrum(300, 1.0, 100.0)
        rec, rnorm, orth = run_convergence_experiment(A, "diag300", n_iters=40, s=4)
        assert rnorm.shape[0] == 10  # 40/4 outer iterations
        assert orth.shape == (10,)
        assert rec.wall_s > 0


class TestRcmReorder:
    def test_bandwidth_shrinks_and_spectrum_preserved(self):
        import scipy.sparse as sp

        from ca_lanczos_tpu.utils.reorder import rcm_reorder

        # A banded matrix scrambled by a random permutation: RCM should
        # recover a narrow band.
        rng = np.random.default_rng(0)
        n = 120
        band = sp.diags(
            [rng.standard_normal(n - 2), rng.standard_normal(n) + 4, rng.standard_normal(n - 2)],
            [-2, 0, 2],
        ).tocsr()
        band = (band + band.T) / 2
        p = rng.permutation(n)
        scr = band[p][:, p]
        ro = rcm_reorder(scr)
        assert ro.bandwidth_after < ro.bandwidth_before
        d_orig = np.sort(np.linalg.eigvalsh(band.toarray()))
        d_reord = np.sort(np.linalg.eigvalsh(np.asarray(ro.A.to_dense())))
        np.testing.assert_allclose(d_reord, d_orig, atol=1e-10)

    def test_restore_roundtrip(self):
        import scipy.sparse as sp

        from ca_lanczos_tpu.utils.reorder import rcm_reorder

        rng = np.random.default_rng(1)
        a = sp.random(50, 50, density=0.1, random_state=3)
        a = a + a.T + 10 * sp.eye(50)
        ro = rcm_reorder(a)
        x = rng.standard_normal(50)
        np.testing.assert_allclose(ro.restore(ro.apply(x)), x)

    def test_solver_on_reordered(self):
        """End-to-end: scrambled banded SPD matrix -> RCM -> restarted
        driver on the DIA operator -> correct eigenvalues."""
        import scipy.sparse as sp

        from ca_lanczos_tpu.config import Basis, LanczosConfig, Orth
        from ca_lanczos_tpu.solvers.restarted import restarted_ca_lanczos
        from ca_lanczos_tpu.utils.reorder import rcm_reorder

        rng = np.random.default_rng(2)
        n = 300
        band = sp.diags(
            [np.full(n - 1, -1.0), np.linspace(4, 40, n), np.full(n - 1, -1.0)], [-1, 0, 1]
        ).tocsr()
        p = rng.permutation(n)
        scr = band[p][:, p]
        ro = rcm_reorder(scr)
        from ca_lanczos_tpu.ops.spmv import DiaMatrix
        assert isinstance(ro.A, DiaMatrix)
        cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=Orth.FULL, n_wanted=4, tol=1e-9)
        res = restarted_ca_lanczos(ro.A, jnp.ones(n), 32, cfg)
        assert res.converged
        exact = np.sort(np.linalg.eigvalsh(band.toarray()))[::-1][:4]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-7)


class TestSolveCli:
    def test_solve_mtx_end_to_end(self, tmp_path):
        """python -m ca_lanczos_tpu solve --mtx <file>: loader -> router ->
        escalating drivers -> JSON record (the reference user's "give me
        eigenvalues of this Matrix Market file" path)."""
        import json

        from ca_lanczos_tpu.__main__ import main

        n = 400
        d = np.linspace(1.0, 50.0, n)
        a = sp.diags([d, 0.05 * np.ones(n - 1), 0.05 * np.ones(n - 1)],
                     [0, -1, 1])
        path = str(tmp_path / "band.mtx")
        save_mtx(path, a)
        out = str(tmp_path / "rec.json")
        rc = main(["solve", "--mtx", path, "--n-wanted", "4",
                   "--max-lanczos", "32", "--s", "4", "--out", out])
        assert rc == 0
        rec = json.loads(open(out).read().strip())
        assert rec["converged"] and rec["n"] == n
        exact = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:4]
        np.testing.assert_allclose(rec["eigs"][:4], exact, rtol=1e-7)


    def test_solve_mtx_distributed(self, tmp_path):
        """--mesh N routes through dist_solve_auto on the virtual mesh."""
        import json

        from ca_lanczos_tpu.__main__ import main

        n = 512
        d = np.linspace(1.0, 40.0, n)
        a = sp.diags([d, 0.05 * np.ones(n - 1), 0.05 * np.ones(n - 1)],
                     [0, -1, 1])
        path = str(tmp_path / "band.mtx")
        save_mtx(path, a)
        out = str(tmp_path / "rec.json")
        rc = main(["solve", "--mtx", path, "--n-wanted", "3",
                   "--max-lanczos", "24", "--s", "4", "--mesh", "8",
                   "--out", out])
        assert rc == 0
        rec = json.loads(open(out).read().strip())
        assert rec["converged"] and rec["solver"].startswith("dist_")
        exact = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:3]
        np.testing.assert_allclose(rec["eigs"][:3], exact, rtol=1e-7)

    def test_solve_mtx_hier_mesh(self, tmp_path):
        """--mesh 8 --hosts 2 routes over the hierarchical ('host',
        'chip') mesh (round-5) with the same answers."""
        import json

        from ca_lanczos_tpu.__main__ import main

        n = 512
        d = np.linspace(1.0, 40.0, n)
        a = sp.diags([d, 0.05 * np.ones(n - 1), 0.05 * np.ones(n - 1)],
                     [0, -1, 1])
        path = str(tmp_path / "band.mtx")
        save_mtx(path, a)
        out = str(tmp_path / "rec.json")
        rc = main(["solve", "--mtx", path, "--n-wanted", "3",
                   "--max-lanczos", "24", "--s", "4", "--mesh", "8",
                   "--hosts", "2", "--out", out])
        assert rc == 0
        rec = json.loads(open(out).read().strip())
        assert rec["converged"] and rec["solver"].startswith("dist_")
        exact = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:3]
        np.testing.assert_allclose(rec["eigs"][:3], exact, rtol=1e-7)


class TestSolveAutoFusedEngine:
    def test_fused_engine_first_leg(self):
        """engine='fused' routes the explicit-restart leg through the
        one-XLA-call driver and converges on a gapped spectrum."""
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.harness.auto import solve_auto
        from ca_lanczos_tpu.utils.matrices import diag_spectrum

        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        cfg = LanczosConfig(n_wanted=6, s=4, tol=1e-8)
        res = solve_auto(A, np.ones(n), 32, cfg, engine="fused")
        assert res.converged and res.solver == "restarted_ca_lanczos"
        exact = np.linspace(1.0, 100.0, n)[::-1][:6]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-9)



class TestWhichSmallest:
    def test_solve_auto_smallest_end(self):
        """which='smallest' targets the bottom of the spectrum via
        operator negation; eigenvalues come back un-negated and the
        Ritz vectors are genuine eigenvectors of the ORIGINAL matrix."""
        import scipy.sparse as sp

        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.harness.auto import solve_auto

        n = 3000
        d = np.linspace(5.0, 100.0, n)
        d[:3] = [1.0, 1.5, 2.0]  # separated bottom triple
        a = sp.diags([d, 0.01 * np.ones(n - 1), 0.01 * np.ones(n - 1)],
                     [0, -1, 1]).tocsr()
        rng = np.random.default_rng(0)
        res = solve_auto(
            a, rng.standard_normal(n), 32,
            LanczosConfig(n_wanted=3, s=4, tol=1e-9),
            which="smallest",
        )
        assert res.converged
        from scipy.sparse.linalg import eigsh

        oracle = np.sort(eigsh(a, k=3, which="SA",
                               return_eigenvectors=False))
        np.testing.assert_allclose(np.sort(res.eigs), oracle, rtol=1e-8)
        Q = np.asarray(res.Q_conv)
        for j in range(3):
            q = Q[:, j] / np.linalg.norm(Q[:, j])
            lam = q @ (a @ q)
            assert np.linalg.norm(a @ q - lam * q) < 1e-6

    def test_which_validation(self):
        from ca_lanczos_tpu.harness.auto import solve_auto
        from ca_lanczos_tpu.utils.matrices import diag_spectrum

        with pytest.raises(ValueError, match="which"):
            solve_auto(diag_spectrum(100, 1.0, 10.0), np.ones(100), 16,
                       which="median")


class TestEscalationLadder:
    """Ladder structure (round-3): probe-ordered drivers first, then the
    numerically-safe rescue rungs that close the s=10 Newton-conditioning
    corpus holdouts (results/corpus_summary.json: 552/552)."""

    def test_rungs_and_labels(self):
        from ca_lanczos_tpu.config import LanczosConfig, Orth
        from ca_lanczos_tpu.harness.auto import _ladder

        cfg = LanczosConfig(s=10, orth=Orth.LOCAL)
        rungs = _ladder(cfg, "restarted_ca_lanczos", "impl_restarted_ca_lanczos")
        labels = [r[2] for r in rungs]
        assert labels == [
            "restarted_ca_lanczos",
            "impl_restarted_ca_lanczos",
            "impl_restarted_ca_lanczos[orth=full]",
            "impl_restarted_ca_lanczos[s=4,orth=full]",
            "restarted_ca_lanczos[s=4,orth=full]",
        ]
        assert rungs[2][1].orth == Orth.FULL and rungs[2][1].s == 10
        assert rungs[3][1].s == 4
        # budget never grows on the reference-budget rungs
        assert all(r[1].max_restarts == cfg.max_restarts for r in rungs)
        assert all(r[3] is None for r in rungs)

    def test_larger_basis_rung_when_budget_small(self):
        """Round-5: the m=96 IRL closer rung appears exactly when the
        caller's budget is below 96, and its override is explicit."""
        from ca_lanczos_tpu.config import LanczosConfig, Orth
        from ca_lanczos_tpu.harness.auto import _M_LARGE, _ladder

        cfg = LanczosConfig(s=6, orth=Orth.LOCAL)
        rungs = _ladder(cfg, "restarted_ca_lanczos",
                        "impl_restarted_ca_lanczos", max_lanczos=60)
        assert rungs[-1][2] == "impl_restarted_ca_lanczos[orth=full,m=96]"
        assert rungs[-1][3] == _M_LARGE
        big = _ladder(cfg, "restarted_ca_lanczos",
                      "impl_restarted_ca_lanczos", max_lanczos=128)
        assert all(r[3] is None for r in big)

    def test_safe_config_has_no_rescue_rungs(self):
        from ca_lanczos_tpu.config import LanczosConfig, Orth
        from ca_lanczos_tpu.harness.auto import _ladder

        cfg = LanczosConfig(s=4, orth=Orth.FULL)
        rungs = _ladder(cfg, "restarted_ca_lanczos", "impl_restarted_ca_lanczos")
        assert len(rungs) == 2

    def test_escalate_walks_to_converging_rung(self):
        from ca_lanczos_tpu.harness.auto import _escalate

        class R:
            def __init__(self, conv, eigs):
                self.converged = conv
                self.eigs = np.asarray(eigs, float)

        calls = []

        def run(name, c, m):
            calls.append(name)
            return R(len(calls) == 3, [1.0] * len(calls))

        rungs = [(f"d{i}", None, f"d{i}", None) for i in range(4)]
        res, label, esc = _escalate(run, rungs)
        assert label == "d2" and esc and res.converged
        assert calls == ["d0", "d1", "d2"]  # stops at convergence

    @pytest.mark.slow
    def test_m96_rung_closes_near_degenerate_top(self):
        """The mesh_2d_aniso corpus closer (round-5 VERDICT item 4):
        eps=1e-3 anisotropic 2-D Laplacian, 1e-6-relative top gaps —
        unconverged on every 60-vector rung, converged by the m=96 IRL
        rung to ~1e-12."""
        import scipy.sparse as sp
        from scipy.sparse.linalg import eigsh

        from ca_lanczos_tpu.config import LanczosConfig, Orth
        from ca_lanczos_tpu.harness.auto import solve_auto

        g, eps = 72, 1e-3
        n = g * g
        a = sp.diags(
            [-eps * np.ones(n - g), -np.ones(n - 1),
             2 * (1 + eps) * np.ones(n), -np.ones(n - 1),
             -eps * np.ones(n - g)], [-g, -1, 0, 1, g]).tocsr()
        a = a / sp.linalg.norm(a, np.inf)
        oracle = np.sort(eigsh(a, k=10, which="LA",
                               return_eigenvectors=False))[::-1]
        res = solve_auto(a, np.random.default_rng(0).standard_normal(n), 60,
                         LanczosConfig(tol=1e-9, orth=Orth.FULL))
        assert res.converged
        assert res.solver.endswith("m=96]"), res.solver
        got = np.sort(np.asarray(res.eigs, float))[::-1][:10]
        assert np.max(np.abs(got - oracle)) / oracle[0] < 1e-8

    def test_escalate_keeps_most_locked_on_total_failure(self):
        from ca_lanczos_tpu.harness.auto import _escalate

        class R:
            def __init__(self, eigs):
                self.converged = False
                self.eigs = np.asarray(eigs, float)

        seq = [R([1.0]), R([1.0, 2.0, 3.0]), R([1.0, 2.0])]
        res, label, esc = _escalate(
            lambda name, c, m: seq.pop(0),
            [(f"d{i}", None, f"d{i}", None) for i in range(3)],
        )
        assert label == "d1" and esc and len(res.eigs) == 3


class TestTwoStagePolish:
    """Round-5: solve_auto(polish=, over_lock=) — the two-stage pipeline
    (loose solve + f64 Rayleigh-Ritz polish) as a first-class API."""

    def _op(self, n=4096):
        d = np.linspace(1.0, 90.0, n)
        d[-5:] = np.linspace(95.0, 100.0, 5)
        rng = np.random.default_rng(0)
        off = rng.standard_normal(n - 1) * 1e-3
        return sp.diags([off, d, off], [-1, 0, 1], format="csr"), d

    def test_loose_solve_plus_polish_reaches_f64_grade(self):
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.harness.auto import solve_auto

        a, _ = self._op()
        exact = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:5]
        rng = np.random.default_rng(1)
        cfg = LanczosConfig(n_wanted=5, s=4, tol=1e-5, max_restarts=100)
        res = solve_auto(a, rng.standard_normal(a.shape[0]), 32, cfg,
                         polish=6, over_lock=3)
        assert res.converged and res.solver.endswith("+polish6")
        assert len(res.eigs) == 5 and res.polish_resid is not None
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact,
                                   rtol=1e-10)
        assert res.Q_conv.shape[1] == 5

    def test_polish_smallest_end(self):
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.harness.auto import solve_auto

        a, _ = self._op()
        exact = np.sort(np.linalg.eigvalsh(a.toarray()))[:3]
        rng = np.random.default_rng(2)
        cfg = LanczosConfig(n_wanted=3, s=4, tol=1e-5, max_restarts=100)
        res = solve_auto(a, rng.standard_normal(a.shape[0]), 32, cfg,
                         which="smallest", polish=6, over_lock=2)
        assert res.converged
        # bottom-end gaps are tighter (linspace spacing ~2e-2), so the
        # fixed 6-pass polish lands ~1e-8-grade there
        np.testing.assert_allclose(np.sort(res.eigs)[:3], exact, rtol=1e-7)

    def test_polish_requires_f64_source(self):
        import jax.numpy as jnp
        import pytest as _pytest

        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.harness.auto import solve_auto
        from ca_lanczos_tpu.ops.spmv import EllMatrix

        a, _ = self._op(512)
        A = EllMatrix.from_scipy(sp.csr_matrix(a).astype(np.float32))
        with _pytest.raises(ValueError, match="f64 operator source"):
            solve_auto(A, jnp.ones(512, jnp.float32), 32,
                       LanczosConfig(n_wanted=3), polish=2)

    def test_host_polish_path_general_sparsity(self):
        """A permuted/general route falls to the host SpMM polish."""
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.harness.auto import solve_auto

        n = 1024
        rng = np.random.default_rng(3)
        d = np.linspace(1.0, 50.0, n)
        d[-3:] = [60.0, 65.0, 70.0]
        rows = np.repeat(np.arange(n), 3)
        cols = np.clip(rows + rng.integers(-6, 7, rows.shape), 0, n - 1)
        off = sp.csr_matrix(
            (rng.standard_normal(rows.shape) * 1e-3, (rows, cols)), (n, n))
        a = (off + off.T + sp.diags(d)).tocsr()
        exact = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:3]
        cfg = LanczosConfig(n_wanted=3, s=4, tol=1e-5, max_restarts=100)
        res = solve_auto(a, rng.standard_normal(n), 32, cfg,
                         polish=5, over_lock=2, prefer="ell")
        assert res.converged
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact,
                                   rtol=1e-9)
