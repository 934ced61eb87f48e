"""dist_solve_auto: raw matrix -> routed distributed escalating solve on
the 8-way mesh (multi-chip counterpart of harness.solve_auto; reference
corpus seam test_restarted_ca_lanczos_all_matrices.m:59)."""

import numpy as np
import pytest
import scipy.sparse as sp

from ca_lanczos_tpu.config import LanczosConfig
from ca_lanczos_tpu.parallel import (
    dist_solve_auto,
    make_mesh,
    partition_operator,
    route_dist_operator,
)
from ca_lanczos_tpu.ops.spmv import DiaMatrix, EllMatrix


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _band(n, d, off=0.05):
    o = off * np.ones(n - 1)
    return sp.diags([d, o, o], [0, -1, 1]).tocsr()


class TestRouteDistOperator:
    def test_banded_to_dia(self, mesh):
        n = 1024
        a = _band(n, np.linspace(1.0, 50.0, n))
        A, route = route_dist_operator(a, mesh, s_max=4)
        assert isinstance(A, DiaMatrix) and route.format == "dia"
        assert route.perm is None

    def test_wide_band_needs_rcm(self, mesh):
        # permuted band: raw bandwidth ~n breaks the halo rule; RCM
        # recovers it
        n = 2048
        band = _band(n, 2.0 * np.ones(n))
        p = np.random.default_rng(0).permutation(n)
        scat = sp.csr_matrix(band[p][:, p])
        A, route = route_dist_operator(scat, mesh, s_max=4)
        assert route.perm is not None
        assert route.bandwidth_after < route.bandwidth_before
        assert route.format == "dia" and isinstance(A, DiaMatrix)

    def test_unshardable_raises(self, mesh):
        # dense-ish random scatter RCM cannot band: halo >= shard
        n = 512  # 64 rows/shard on the 8-way mesh
        rng = np.random.default_rng(1)
        rows = np.repeat(np.arange(n), 4)
        cols = rng.integers(0, n, rows.shape)
        a = sp.csr_matrix((np.ones(rows.shape), (rows, cols)), (n, n))
        a = (a + a.T).tocsr()
        with pytest.raises(ValueError, match="row-sharded"):
            route_dist_operator(a, mesh, s_max=8)

    def test_partition_operator_type_error(self, mesh):
        with pytest.raises(TypeError):
            partition_operator(object(), mesh, s_max=4)


class TestDistSolveAuto:
    def test_banded_converges(self, mesh):
        n = 1024
        d = np.linspace(1.0, 100.0, n)
        a = _band(n, d)
        cfg = LanczosConfig(n_wanted=4, s=4, tol=1e-9)
        res = dist_solve_auto(
            a, np.ones(n), 32, mesh, cfg
        )
        assert res.converged and res.solver == "dist_restarted_ca_lanczos"
        from scipy.sparse.linalg import eigsh

        oracle = np.sort(
            eigsh(a, k=4, which="LA", return_eigenvectors=False)
        )[::-1]
        np.testing.assert_allclose(
            np.sort(res.eigs)[::-1], oracle, rtol=1e-8
        )

    def test_two_stage_polish(self, mesh):
        """Round-5: dist_solve_auto(polish=, over_lock=) — loose dist
        solve + f64 polish of the gathered block (harness._polish_block)."""
        n = 1024
        d = np.linspace(1.0, 90.0, n)
        d[-4:] = np.linspace(95.0, 100.0, 4)
        a = _band(n, d)
        cfg = LanczosConfig(n_wanted=4, s=4, tol=1e-5, max_restarts=100)
        res = dist_solve_auto(a, np.ones(n), 32, mesh, cfg,
                              polish=6, over_lock=2)
        assert res.converged and res.solver.endswith("+polish6")
        assert len(res.eigs) == 4 and res.polish_resid is not None
        from scipy.sparse.linalg import eigsh

        oracle = np.sort(
            eigsh(a, k=4, which="LA", return_eigenvectors=False)
        )[::-1]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], oracle,
                                   rtol=1e-9)

    def test_reordered_general_sparsity(self, mesh):
        # permuted band -> RCM -> dist solve; Ritz vectors decode to the
        # ORIGINAL ordering
        n = 1024
        d = np.linspace(1.0, 2.0, n)
        d[-1] = 3.0
        band = _band(n, d, off=0.01)
        rng = np.random.default_rng(3)
        p = rng.permutation(n)
        scat = sp.csr_matrix(band[p][:, p])
        cfg = LanczosConfig(n_wanted=1, s=4, tol=1e-9)
        res = dist_solve_auto(scat, rng.standard_normal(n), 24, mesh, cfg)
        assert res.converged and res.route.perm is not None
        Q = np.asarray(res.Q_conv)
        q = Q[:, 0] / np.linalg.norm(Q[:, 0])
        lam = q @ (scat @ q)
        assert np.linalg.norm(scat @ q - lam * q) < 1e-7
        assert abs(lam - np.max(res.eigs)) < 1e-9


class TestDistRitzVectorAlignment:
    def test_clustered_true_residuals(self, mesh):
        """Regression: Q_cycle must include block 0's LAST column (q_s).
        The misassembled basis produced Ritz vectors with O(1e-3) true
        residuals while the estimate claimed 1e-18, and the clustered
        spectrum below burned all 200 restarts instead of ~8."""
        from ca_lanczos_tpu.parallel import dist_restarted_ca_lanczos
        from ca_lanczos_tpu.ops.formats import dia_from_scipy

        n = 1024
        d = np.r_[np.linspace(1.0, 2.0, n - 1), 3.0]
        a = _band(n, d, off=0.01)
        A = dia_from_scipy(a)
        rng = np.random.default_rng(3)
        cfg = LanczosConfig(n_wanted=2, s=4, tol=1e-9)
        res = dist_restarted_ca_lanczos(A, rng.standard_normal(n), 24, mesh, cfg)
        assert res.converged and res.n_restarts < 30
        Q = np.asarray(res.Q_conv)
        for j in range(2):
            q = Q[:, j] / np.linalg.norm(Q[:, j])
            lam = q @ (a @ q)
            assert np.linalg.norm(a @ q - lam * q) < 1e-7, (j, lam)


class TestDistMixedPrecision:
    @pytest.mark.slow
    def test_dist_f32_storage_f64_reductions(self, mesh):
        """Distributed mixed precision (f32 basis/SpMV, f64 psum'd
        Gram/R/T): eigenvalue error well below the plain-f32 floor, and
        the plain-f32 run never beats it (mirror of the host
        TestMpFlagship on the 8-way mesh)."""
        import dataclasses

        import jax.numpy as jnp

        from ca_lanczos_tpu.config import (
            Basis,
            LanczosConfig,
            Orth,
            OrthParams,
            QrMethod,
        )
        from ca_lanczos_tpu.ops.spmv import DiaMatrix
        from ca_lanczos_tpu.parallel import dist_restarted_ca_lanczos
        from ca_lanczos_tpu.utils.matrices import diag_spectrum

        n = 4096
        A64 = diag_spectrum(n, 1.0, 100.0)
        A32 = DiaMatrix(
            data=jnp.asarray(np.asarray(A64.data), jnp.float32),
            offsets=A64.offsets,
        )
        exact = np.linspace(1.0, 100.0, n)[::-1][:6]
        r = np.ones(n, np.float32)

        base = LanczosConfig(
            s=6, basis=Basis.NEWTON, orth=Orth.LOCAL, n_wanted=6, tol=1e-7,
            orth_params=OrthParams(qr_method=QrMethod.CHOLQR2),
        )
        cfg_mp = dataclasses.replace(
            base,
            orth_params=OrthParams(
                qr_method=QrMethod.CHOLQR2, mixed_precision=True
            ),
        )

        res_mp = dist_restarted_ca_lanczos(A32, r, 48, mesh, cfg_mp)
        assert res_mp.converged
        err_mp = np.max(np.abs(np.sort(res_mp.eigs)[::-1] - exact)) / 100.0
        assert err_mp <= 1e-6, f"dist mp eig err {err_mp:.2e}"

        res_32 = dist_restarted_ca_lanczos(A32, r, 48, mesh, base)
        if res_32.converged and len(res_32.eigs) == 6:
            err_32 = np.max(
                np.abs(np.sort(res_32.eigs)[::-1] - exact)
            ) / 100.0
            assert err_mp <= err_32 + 1e-12

    def test_dist_ca_lanczos_mp_T_accuracy(self, mesh):
        """Non-restarted dist driver: mixed-precision T matches the f64
        run far better than plain f32."""
        from ca_lanczos_tpu.config import Basis
        from ca_lanczos_tpu.ops.spmv import DiaMatrix
        from ca_lanczos_tpu.parallel import dist_ca_lanczos
        from ca_lanczos_tpu.utils.matrices import diag_spectrum

        import jax.numpy as jnp

        n = 2048
        A64 = diag_spectrum(n, 1.0, 60.0)
        A32 = DiaMatrix(
            data=jnp.asarray(np.asarray(A64.data), jnp.float32),
            offsets=A64.offsets,
        )
        rng = np.random.default_rng(0)
        r = rng.standard_normal(n)
        res64 = dist_ca_lanczos(A64, r, 4, 16, mesh, basis=Basis.MONOMIAL)
        res32 = dist_ca_lanczos(A32, r.astype(np.float32), 4, 16, mesh,
                                basis=Basis.MONOMIAL)
        resmp = dist_ca_lanczos(A32, r.astype(np.float32), 4, 16, mesh,
                                basis=Basis.MONOMIAL, mixed_precision=True)
        t64, t32, tmp = (np.asarray(x.T) for x in (res64, res32, resmp))
        err32 = np.max(np.abs(t32 - t64))
        errmp = np.max(np.abs(tmp - t64))
        assert errmp < err32
        assert errmp < 1e-4, (errmp, err32)
