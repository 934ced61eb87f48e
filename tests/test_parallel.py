"""Multi-device tests on the 8-way virtual CPU mesh (conftest.py):
distributed kernels must match the single-chip path to roundoff, and the
distributed CA-Lanczos driver must match single-chip Ritz values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ca_lanczos_tpu.config import Basis, Orth
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers
from ca_lanczos_tpu.ops.qr import tsqr
from ca_lanczos_tpu.parallel import (
    DistDia,
    dist_ca_lanczos,
    dist_matrix_powers,
    dist_spmv,
    local_cholqr,
    local_tsqr,
    make_mesh,
)
from ca_lanczos_tpu.parallel.mesh import ROWS
from ca_lanczos_tpu.solvers.ca_lanczos import build_basis_matrix, ca_lanczos
from ca_lanczos_tpu.parallel.step import newton_coeffs
from ca_lanczos_tpu.utils.matrices import diag_spectrum, laplacian_1d, laplacian_2d
from jax.sharding import PartitionSpec


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _dense_recurrence(A, x, diag, sub):
    """f64 host oracle of V[:,k+1] = A V[:,k] - diag[k] V[:,k] - sub[k]
    V[:,k-1] — (n, s+1); A is a DiaMatrix, applied as scipy CSR built
    from its planes."""
    import scipy.sparse as sp

    data = np.asarray(A.data, np.float64)
    n = data.shape[1]
    rows, cols, vals = [], [], []
    for k, o in enumerate(A.offsets):
        i = np.arange(max(0, -o), min(n, n - o))
        rows.append(i)
        cols.append(i + o)
        vals.append(data[k, i])
    Ad = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    s = len(diag)
    W = np.zeros((len(x), s + 1))
    W[:, 0] = x
    for k in range(s):
        W[:, k + 1] = Ad @ W[:, k] - diag[k] * W[:, k]
        if k > 0:
            W[:, k + 1] -= sub[k] * W[:, k - 1]
    return W


class TestMakeMesh:
    def test_more_devices_than_visible_raises(self):
        # Silent truncation would run a "P-way" job on fewer shards.
        with pytest.raises(ValueError, match="only 8 device"):
            make_mesh(16)


class TestDistSpmv:
    def test_matches_local(self, mesh):
        n = 128
        A = laplacian_1d(n)
        Adist = DistDia.from_dia(A, mesh, s_max=4)
        x = np.random.default_rng(0).standard_normal(n)
        xs = Adist.shard_vector(x, mesh)
        y = np.asarray(dist_spmv(Adist, xs, mesh))[:n]
        y_ref = np.asarray(A.matvec(jnp.asarray(x)))
        np.testing.assert_allclose(y, y_ref, atol=1e-13)

    def test_uneven_rows_padded(self, mesh):
        n = 123  # not divisible by 8
        A = laplacian_1d(n)
        Adist = DistDia.from_dia(A, mesh, s_max=2)
        x = np.random.default_rng(1).standard_normal(n)
        xs = Adist.shard_vector(x, mesh)
        y = np.asarray(dist_spmv(Adist, xs, mesh))[:n]
        np.testing.assert_allclose(y, np.asarray(A.matvec(jnp.asarray(x))), atol=1e-13)


class TestDistMatrixPowers:
    @pytest.mark.parametrize("s", [1, 2, 4, 8])
    def test_monomial(self, mesh, s):
        n = 256
        A = laplacian_1d(n)
        Adist = DistDia.from_dia(A, mesh, s_max=s)
        x = np.random.default_rng(2).standard_normal(n)
        xs = Adist.shard_vector(x, mesh)
        z = jnp.zeros(s)
        V = np.asarray(dist_matrix_powers(Adist, xs, s, z, z, mesh))[:n]
        V_ref = np.asarray(matrix_powers(A, jnp.asarray(x), s, None, Basis.MONOMIAL))
        np.testing.assert_allclose(V, V_ref, rtol=1e-12, atol=1e-10)

    def test_newton_2d(self, mesh):
        nx, ny = 16, 64  # bandwidth nx=16; halo s*16=64 < 128 rows/shard
        A = laplacian_2d(nx, ny)
        s = 4
        Adist = DistDia.from_dia(A, mesh, s_max=s)
        x = np.random.default_rng(3).standard_normal(nx * ny)
        q = jnp.asarray(x)
        Bk = build_basis_matrix(A, q / jnp.linalg.norm(q), s, Basis.NEWTON)
        diag, sub = newton_coeffs(Bk)
        xs = Adist.shard_vector(x, mesh)
        V = np.asarray(
            dist_matrix_powers(Adist, xs, s, jnp.asarray(diag), jnp.asarray(sub), mesh)
        )[: nx * ny]
        from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_from_B

        V_ref = np.asarray(matrix_powers_from_B(A, q, Bk))
        np.testing.assert_allclose(V, V_ref, rtol=1e-12, atol=1e-10)

    @pytest.mark.parametrize("s", [2, 4])
    def test_large_shard_matches_dense_oracle(self, mesh, s):
        """Distributed scan with n_local = 1024 rows per shard against
        the dense f64 recurrence on the owned centers."""
        n = 8 * 1024
        A = laplacian_1d(n)
        x = np.random.default_rng(7).standard_normal(n)
        z = jnp.zeros(s)
        Ad = DistDia.from_dia(A, mesh, s_max=s)
        xs = Ad.shard_vector(x, mesh)
        V = np.asarray(dist_matrix_powers(Ad, xs, s, z, z, mesh))[:n]
        W = _dense_recurrence(A, x, np.zeros(s), np.zeros(s))
        np.testing.assert_allclose(V, W, rtol=1e-13, atol=1e-12)

    def test_newton_coeffs_match_dense_oracle(self, mesh):
        """Nonzero Newton recurrence coefficients on the distributed scan."""
        n, s = 8 * 1024, 4
        A = laplacian_1d(n)
        x = np.random.default_rng(8).standard_normal(n)
        rng = np.random.default_rng(9)
        diag, sub = rng.standard_normal(s), rng.standard_normal(s)
        Ad = DistDia.from_dia(A, mesh, s_max=s)
        xs = Ad.shard_vector(x, mesh)
        V = np.asarray(dist_matrix_powers(
            Ad, xs, s, jnp.asarray(diag), jnp.asarray(sub), mesh))[:n]
        W = _dense_recurrence(A, x, diag, sub)
        np.testing.assert_allclose(V, W, rtol=1e-13, atol=1e-11)


class TestDistOrth:
    def test_tsqr(self, mesh):
        n, m = 512, 7
        X = np.random.default_rng(4).standard_normal((n, m))
        Xs = jax.device_put(jnp.asarray(X), jax.NamedSharding(mesh, PartitionSpec(ROWS)))
        Q, R = jax.jit(
            jax.shard_map(
                local_tsqr,
                mesh=mesh,
                in_specs=PartitionSpec(ROWS),
                out_specs=(PartitionSpec(ROWS), PartitionSpec()),
            )
        )(Xs)
        Q, R = np.asarray(Q), np.asarray(R)
        assert np.all(np.diag(R) >= 0)  # sign-fix parity (tsqr.m:9-11)
        np.testing.assert_allclose(Q @ R, X, atol=1e-12)
        np.testing.assert_allclose(Q.T @ Q, np.eye(m), atol=1e-12)
        # Matches the single-chip TSQR up to nothing at all: same sign fix.
        Qr, Rr = tsqr(jnp.asarray(X))
        np.testing.assert_allclose(R, np.asarray(Rr), rtol=1e-8, atol=1e-10)

    def test_cholqr(self, mesh):
        n, m = 512, 5
        X = np.random.default_rng(5).standard_normal((n, m))
        Xs = jax.device_put(jnp.asarray(X), jax.NamedSharding(mesh, PartitionSpec(ROWS)))
        Q, R = jax.jit(
            jax.shard_map(
                local_cholqr,
                mesh=mesh,
                in_specs=PartitionSpec(ROWS),
                out_specs=(PartitionSpec(ROWS), PartitionSpec()),
            )
        )(Xs)
        Q, R = np.asarray(Q), np.asarray(R)
        np.testing.assert_allclose(Q @ R, X, atol=1e-10)
        np.testing.assert_allclose(Q.T @ Q, np.eye(m), atol=1e-10)


class TestDistCaLanczos:
    @pytest.mark.parametrize("s", [2, 4])
    def test_ritz_parity_monomial(self, mesh, s):
        n = 256
        A = laplacian_1d(n)
        r = jnp.ones((n,), jnp.float64)
        steps = 24
        res_d = dist_ca_lanczos(A, r, s, steps, mesh, basis=Basis.MONOMIAL)
        res_1 = ca_lanczos(A, r, s, steps, basis=Basis.MONOMIAL, orth=Orth.LOCAL)
        d_dist = np.sort(np.linalg.eigvalsh(res_d.T))
        d_one = np.sort(np.linalg.eigvalsh(res_1.T))
        np.testing.assert_allclose(d_dist, d_one, rtol=1e-9, atol=1e-9)

    def test_ritz_parity_newton(self, mesh):
        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        r = jnp.ones((n,), jnp.float64)
        s, steps = 4, 48
        q = r / jnp.linalg.norm(r)
        Bk = build_basis_matrix(A, q, s, Basis.NEWTON)
        res_d = dist_ca_lanczos(A, r, s, steps, mesh, basis=Basis.NEWTON, Bk=Bk)
        res_1 = ca_lanczos(A, r, s, steps, basis=Basis.NEWTON, orth=Orth.LOCAL, Bk=Bk)
        d_dist = np.sort(np.linalg.eigvalsh(res_d.T))
        d_one = np.sort(np.linalg.eigvalsh(res_1.T))
        np.testing.assert_allclose(d_dist, d_one, rtol=1e-7, atol=1e-7)
        # The largest Ritz value approaches the true spectrum top (full
        # convergence needs a restarted driver; parity above is the point).
        np.testing.assert_allclose(d_dist[-1], 100.0, rtol=1e-4)

    def test_basis_orthonormal(self, mesh):
        n = 256
        A = laplacian_1d(n)
        r = jnp.ones((n,), jnp.float64)
        res = dist_ca_lanczos(A, r, 4, 16, mesh, basis=Basis.MONOMIAL)
        Q = res.Q
        G = Q.T @ Q
        np.testing.assert_allclose(G, np.eye(G.shape[0]), atol=1e-8)

    @pytest.mark.parametrize("orth", [Orth.FULL, Orth.PERIODIC, Orth.SELECTIVE])
    def test_orth_modes_parity(self, mesh, orth):
        """All four orth modes on the mesh (reference ca_lanczos.m:27-39);
        Ritz values must match the host driver and the basis must stay
        orthonormal at the mode's guarantee level (VERDICT item 8)."""
        n = 400
        A = diag_spectrum(n, 1.0, 1000.0)  # wide spread: orth loss visible
        r = jnp.ones((n,), jnp.float64)
        s, steps = 4, 40
        res_d = dist_ca_lanczos(A, r, s, steps, mesh, basis=Basis.MONOMIAL, orth=orth)
        res_1 = ca_lanczos(A, r, s, steps, basis=Basis.MONOMIAL, orth=orth)
        d_dist = np.sort(np.linalg.eigvalsh(res_d.T))
        d_one = np.sort(np.linalg.eigvalsh(res_1.T))
        # Converged (top) Ritz values agree with the host driver.
        np.testing.assert_allclose(d_dist[-5:], d_one[-5:], rtol=1e-6)
        if orth == Orth.FULL:
            Q = res_d.Q
            G = Q.T @ Q
            np.testing.assert_allclose(G, np.eye(G.shape[0]), atol=1e-8)

    def test_full_orth_beats_local(self, mesh):
        """FULL must keep the distributed basis orthonormal where LOCAL
        visibly loses orthogonality."""
        n = 400
        A = diag_spectrum(n, 1.0, 1000.0)
        r = jnp.ones((n,), jnp.float64)
        s, steps = 4, 48
        q_full = dist_ca_lanczos(A, r, s, steps, mesh, orth=Orth.FULL).Q
        q_local = dist_ca_lanczos(A, r, s, steps, mesh, orth=Orth.LOCAL).Q
        e_full = np.max(np.abs(q_full.T @ q_full - np.eye(q_full.shape[1])))
        e_local = np.max(np.abs(q_local.T @ q_local - np.eye(q_local.shape[1])))
        assert e_full < 1e-10
        assert e_full < e_local


class TestDistRestarted:
    def test_flagship_parity(self, mesh):
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        r = np.ones(n)
        cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=Orth.LOCAL, n_wanted=6, tol=1e-8)
        res = dist_restarted_ca_lanczos(A, r, 32, mesh, cfg)
        assert res.converged
        exact = np.linspace(1, 100, n)[::-1][:6]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-9)
        # Locked Ritz vectors are orthonormal and satisfy the residual tol.
        Q = np.asarray(res.Q_conv)
        np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-8)


class TestScalingSweep:
    def test_weak_scaling_plumbing(self):
        from ca_lanczos_tpu.parallel.runtime import scaling_sweep

        recs = scaling_sweep((1, 2, 4), rows_per_device=4096, s=4, reps=2)
        assert [r["devices"] for r in recs] == [1, 2, 4]
        for r in recs:
            assert r["nnz_per_s"] > 0
        assert recs[0]["weak_efficiency"] == 1.0


class TestDistEll:
    @pytest.mark.parametrize("s", [1, 2, 4])
    def test_matches_single_chip(self, mesh, s):
        from ca_lanczos_tpu.ops.spmv import EllMatrix
        from ca_lanczos_tpu.parallel.dist_ell import DistEll, dist_ell_matrix_powers

        nx, ny = 8, 64  # bandwidth 8 -> halo s*8 <= 32 < 64 rows/shard
        A = laplacian_2d(nx, ny)
        Aell = EllMatrix.from_dense(np.asarray(A.to_dense()))
        n = nx * ny
        Adist = DistEll.from_ell(Aell, mesh, s_max=s)
        x = np.random.default_rng(5).standard_normal(n)
        xs = Adist.shard_vector(x, mesh)
        z = jnp.zeros(s)
        V = np.asarray(dist_ell_matrix_powers(Adist, xs, s, z, z, mesh))[:n]
        V_ref = np.asarray(matrix_powers(Aell, jnp.asarray(x), s, None, Basis.MONOMIAL))
        np.testing.assert_allclose(V, V_ref, rtol=1e-11, atol=1e-9)

    def test_newton_coeffs(self, mesh):
        from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_from_B
        from ca_lanczos_tpu.ops.spmv import EllMatrix
        from ca_lanczos_tpu.parallel.dist_ell import DistEll, dist_ell_matrix_powers

        nx, ny = 8, 64
        A = laplacian_2d(nx, ny)
        Aell = EllMatrix.from_dense(np.asarray(A.to_dense()))
        n = nx * ny
        s = 4
        q = jnp.asarray(np.random.default_rng(6).standard_normal(n))
        Bk = build_basis_matrix(Aell, q / jnp.linalg.norm(q), s, Basis.NEWTON)
        diag, sub = newton_coeffs(Bk)
        Adist = DistEll.from_ell(Aell, mesh, s_max=s)
        xs = Adist.shard_vector(np.asarray(q), mesh)
        V = np.asarray(
            dist_ell_matrix_powers(Adist, xs, s, jnp.asarray(diag), jnp.asarray(sub), mesh)
        )[:n]
        V_ref = np.asarray(matrix_powers_from_B(Aell, q, Bk))
        np.testing.assert_allclose(V, V_ref, rtol=1e-11, atol=1e-9)


class TestDeterminism:
    """SURVEY section 5: deterministic-collective and cross-device
    consistency checks standing in for race detection."""

    def test_dist_block_step_bitwise_deterministic(self, mesh):
        from ca_lanczos_tpu.parallel import dist_first_block
        from ca_lanczos_tpu.utils.debug import check_deterministic

        s = 4
        n = 256
        A = laplacian_1d(n)
        Adist = DistDia.from_dia(A, mesh, s_max=s)
        q = Adist.shard_vector(np.ones(n), mesh)
        z = jnp.zeros(s)
        assert check_deterministic(
            lambda: dist_first_block(Adist, q, z, z, s, mesh), reps=3
        )

    def test_replicated_R_consistent_across_devices(self, mesh):
        from ca_lanczos_tpu.parallel import dist_first_block
        from ca_lanczos_tpu.utils.debug import cross_device_consistency

        s = 4
        n = 256
        A = laplacian_1d(n)
        Adist = DistDia.from_dia(A, mesh, s_max=s)
        q = Adist.shard_vector(np.ones(n), mesh)
        z = jnp.zeros(s)
        _, R = dist_first_block(Adist, q, z, z, s, mesh)
        assert cross_device_consistency(R) == 0.0

    def test_assert_finite(self):
        from ca_lanczos_tpu.utils.debug import assert_finite

        assert_finite({"a": jnp.ones(3)})
        with pytest.raises(FloatingPointError):
            assert_finite(jnp.asarray([1.0, np.nan]))


class TestDistCholqr2Path:
    def test_dist_driver_cholqr2_parity(self, mesh):
        """The throughput QR backend (cholqr2) matches TSQR Ritz
        values on a well-conditioned Newton-basis run."""
        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        r = jnp.ones((n,), jnp.float64)
        s, steps = 4, 32
        q = r / jnp.linalg.norm(r)
        Bk = build_basis_matrix(A, q, s, Basis.NEWTON)
        res_t = dist_ca_lanczos(A, r, s, steps, mesh, basis=Basis.NEWTON, Bk=Bk, qr_method="tsqr")
        res_c = dist_ca_lanczos(A, r, s, steps, mesh, basis=Basis.NEWTON, Bk=Bk, qr_method="cholqr2")
        d_t = np.sort(np.linalg.eigvalsh(res_t.T))
        d_c = np.sort(np.linalg.eigvalsh(res_c.T))
        np.testing.assert_allclose(d_c, d_t, rtol=1e-9, atol=1e-9)


class TestDistEllDriver:
    def test_ell_driver_parity(self, mesh):
        """dist_ca_lanczos on a general ELL operator matches the
        single-chip driver."""
        from ca_lanczos_tpu.ops.spmv import EllMatrix

        nx, ny = 8, 64
        Ad = laplacian_2d(nx, ny)
        A = EllMatrix.from_dense(np.asarray(Ad.to_dense()))
        n = nx * ny
        r = jnp.ones((n,), jnp.float64)
        s, steps = 4, 24
        res_d = dist_ca_lanczos(A, r, s, steps, mesh, basis=Basis.MONOMIAL)
        res_1 = ca_lanczos(A, r, s, steps, basis=Basis.MONOMIAL, orth=Orth.LOCAL)
        d_dist = np.sort(np.linalg.eigvalsh(res_d.T))
        d_one = np.sort(np.linalg.eigvalsh(res_1.T))
        np.testing.assert_allclose(d_dist, d_one, rtol=1e-8, atol=1e-8)


class TestDistRestartedCholqr2:
    def test_flagship_cholqr2(self, mesh):
        from ca_lanczos_tpu.config import LanczosConfig, OrthParams, QrMethod
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        cfg = LanczosConfig(
            s=4, basis=Basis.NEWTON, n_wanted=6, tol=1e-8,
            orth_params=OrthParams(qr_method=QrMethod.CHOLQR2),
        )
        res = dist_restarted_ca_lanczos(A, np.ones(n), 32, mesh, cfg)
        assert res.converged
        exact = np.linspace(1, 100, n)[::-1][:6]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-9)


class TestDistRestartedOrthModes:
    @pytest.mark.parametrize("orth", [Orth.FULL, Orth.PERIODIC, Orth.SELECTIVE])
    def test_flagship_orth_modes(self, mesh, orth):
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=orth, n_wanted=6, tol=1e-8)
        res = dist_restarted_ca_lanczos(A, np.ones(n), 32, mesh, cfg)
        assert res.converged
        exact = np.linspace(1, 100, n)[::-1][:6]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-9)
        Q = np.asarray(res.Q_conv)
        np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-9)


class TestDistRestartedSmallestEnd:
    def test_returns_smallest_end(self, mesh):
        """ADVICE r4 medium regression (dist leg): restart_strategy=
        SMALLEST must return the BOTTOM-end pairs — the overfill trim
        and _finalize used to keep/sort the largest.  Fixture mirrors
        tests/test_restarted.TestSmallestEnd: separated top (converges
        first) + resolvable bottom."""
        from ca_lanczos_tpu.config import LanczosConfig, Orth, RestartStrategy
        from ca_lanczos_tpu.ops.spmv import DiaMatrix
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        n = 480
        d = np.linspace(0.0, 1.0, n)
        d[-3:] = [4.0, 5.0, 6.0]            # separated top end
        d[:4] = [-2.0, -1.7, -1.4, -1.1]    # resolvable bottom end
        A = DiaMatrix(data=jnp.asarray(d[None, :]), offsets=(0,))
        cfg = LanczosConfig(s=4, n_wanted=3, tol=1e-7, max_restarts=100,
                            orth=Orth.FULL,
                            restart_strategy=RestartStrategy.SMALLEST)
        res = dist_restarted_ca_lanczos(A, np.ones(n), 24, mesh, cfg)
        assert res.converged
        got = np.sort(np.asarray(res.eigs))[:3]
        np.testing.assert_allclose(got, [-2.0, -1.7, -1.4], atol=1e-6)
        assert np.all(got < 0.0), got  # no top-end value reported


class TestDistSstep:
    @pytest.mark.parametrize("s,m", [(2, 4), (4, 3)])
    def test_matches_single_chip(self, mesh, s, m):
        from ca_lanczos_tpu.parallel.dist_sstep import dist_sstep_lanczos
        from ca_lanczos_tpu.solvers.sstep import sstep_lanczos

        n = 256
        A = laplacian_1d(n)
        r = np.random.default_rng(7).standard_normal(n)
        res_d = dist_sstep_lanczos(A, r, s, m, mesh)
        res_1 = sstep_lanczos(A, jnp.asarray(r), s, m)
        np.testing.assert_allclose(res_d.T, res_1.T, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(res_d.Q), np.asarray(res_1.Q), rtol=1e-10, atol=1e-10
        )


class TestDistIRL:
    @pytest.mark.parametrize("basis", [Basis.MONOMIAL, Basis.NEWTON])
    def test_diagonal(self, mesh, basis):
        from ca_lanczos_tpu.parallel.dist_irl import dist_impl_restarted_ca_lanczos

        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        res = dist_impl_restarted_ca_lanczos(
            A, np.ones(n), 40, mesh, n_wanted=6, s=4, basis=basis, tol=1e-8
        )
        assert res.converged
        exact = np.linspace(1, 100, n)[::-1][:6]
        np.testing.assert_allclose(res.eigs, exact, rtol=1e-8)


class TestDistLanczos:
    def test_matches_single_chip(self, mesh):
        from ca_lanczos_tpu.parallel import dist_lanczos
        from ca_lanczos_tpu.solvers.lanczos import lanczos as lanczos_1

        n = 256
        A = laplacian_1d(n)
        r = np.random.default_rng(11).standard_normal(n)
        T_d, Q_d = dist_lanczos(A, r, 20, mesh)
        res = lanczos_1(A, jnp.asarray(r), 20, orth="local")
        np.testing.assert_allclose(T_d, res.T, rtol=1e-10, atol=1e-12)


class TestDistRestartedEll:
    def test_general_sparsity_flagship(self, mesh):
        """dist_restarted_ca_lanczos on a general ELL operator."""
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.ops.spmv import EllMatrix
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        nx, ny = 8, 64
        Ad = laplacian_2d(nx, ny)
        A = EllMatrix.from_dense(np.asarray(Ad.to_dense()))
        n = nx * ny
        iv = np.pi * np.arange(1, nx + 1) / (nx + 1)
        jv = np.pi * np.arange(1, ny + 1) / (ny + 1)
        exact = np.sort(
            np.add.outer(2 - 2 * np.cos(iv), 2 - 2 * np.cos(jv)).ravel()
        )[::-1][:4]
        cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=Orth.FULL, n_wanted=4, tol=1e-9)
        res = dist_restarted_ca_lanczos(A, np.ones(n), 32, mesh, cfg)
        assert res.converged
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-8)


class TestPeriodicHalo:
    """Ring-periodic halo: circulant operators distribute (VERDICT item 9;
    reference wrap Hamiltonian runLanczos.m:15-18)."""

    def test_periodic_dia_spmv(self, mesh):
        n = 256
        # Circulant-banded operator: A[i, (i+k) mod n] = data[d, i].
        rng = np.random.default_rng(0)
        offsets = (-2, -1, 0, 1, 2)
        data = rng.standard_normal((5, n))
        from ca_lanczos_tpu.ops.spmv import DiaMatrix as DM
        A = DM(data=jnp.asarray(data), offsets=offsets)
        Ad = DistDia.from_dia(A, mesh, s_max=2, periodic=True)
        x = rng.standard_normal(n)
        xs = Ad.shard_vector(x, mesh)
        y = np.asarray(dist_spmv(Ad, xs, mesh))[:n]
        # Dense circulant oracle
        dense = np.zeros((n, n))
        for d, k in enumerate(offsets):
            dense[np.arange(n), (np.arange(n) + k) % n] = data[d]
        np.testing.assert_allclose(y, dense @ x, atol=1e-12)

    def test_periodic_ell_powers(self, mesh):
        from ca_lanczos_tpu.parallel.dist_ell import DistEll, dist_ell_matrix_powers
        from ca_lanczos_tpu.utils.matrices import harmonic_oscillator
        n, s = 512, 4
        H, _ = harmonic_oscillator(n)  # ELL with mod-n wrap columns
        Hd = DistEll.from_ell(H, mesh, s_max=s, periodic=True)
        x = np.random.default_rng(1).standard_normal(n)
        xs = Hd.shard_vector(x, mesh)
        z = jnp.zeros(s)
        V = np.asarray(dist_ell_matrix_powers(Hd, xs, s, z, z, mesh))[:n]
        V_ref = np.asarray(matrix_powers(H, jnp.asarray(x), s, None, Basis.MONOMIAL))
        np.testing.assert_allclose(V, V_ref, rtol=1e-11, atol=1e-9)

    def test_dist_propagation_matches_single_chip(self, mesh):
        """Distributed split propagation of the reference Hamiltonian
        matches the single-chip split propagator to 1e-9."""
        from ca_lanczos_tpu.parallel.dist_ell import DistEll
        from ca_lanczos_tpu.parallel.dist_prop import dist_propagate_split
        from ca_lanczos_tpu.solvers.propagators import propagate_split
        from ca_lanczos_tpu.utils.matrices import gaussian_packet, harmonic_oscillator

        n = 128
        H, x = harmonic_oscillator(n)
        psi0 = gaussian_packet(x).astype(np.complex128)
        dt, n_steps, kdim = 0.025, 5, 16
        Hd = DistEll.from_ell(H, mesh, s_max=1, periodic=True)
        psi_d = dist_propagate_split(Hd, psi0, dt, n_steps, mesh, krylov_dim=kdim)
        psi_1 = propagate_split(H, psi0, dt, n_steps, krylov_dim=kdim)
        np.testing.assert_allclose(psi_d, np.asarray(psi_1), atol=1e-9)


class TestDistCheckpointAndRecovery:
    """VERDICT item 7: distributed checkpoint/resume and in-jit
    breakdown recovery."""

    def test_kill_resume_mid_solve(self, mesh, tmp_path):
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        r = np.ones(n)
        cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=Orth.LOCAL,
                            n_wanted=6, tol=1e-8)
        ckpt = str(tmp_path / "dist_ck.npz")

        # Uninterrupted reference run.
        ref = dist_restarted_ca_lanczos(A, r, 32, mesh, cfg)
        assert ref.converged

        # "Killed" run: only one restart allowed, checkpoint written.
        import dataclasses as dc
        cfg1 = dc.replace(cfg, max_restarts=1)
        partial_res = dist_restarted_ca_lanczos(
            A, r, 32, mesh, cfg1, checkpoint_path=ckpt
        )
        assert not partial_res.converged

        # Resume from the checkpoint; must converge to the same pairs.
        res = dist_restarted_ca_lanczos(A, r, 32, mesh, cfg, resume_from=ckpt)
        assert res.converged
        np.testing.assert_allclose(
            np.sort(res.eigs), np.sort(ref.eigs), rtol=1e-9
        )

    def test_local_qr_safe_rank_deficient(self, mesh):
        from ca_lanczos_tpu.parallel.dist_orth import local_qr_safe

        n, m = 512, 6
        rng = np.random.default_rng(0)
        X = rng.standard_normal((n, m))
        X[:, 3] = X[:, 1]  # exact deficiency
        X[:, 5] = 2.0 * X[:, 0] - X[:, 2]
        Xs = jax.device_put(jnp.asarray(X), jax.NamedSharding(mesh, PartitionSpec(ROWS)))
        key = jax.random.PRNGKey(7)

        Q, R, rank = jax.jit(
            jax.shard_map(
                lambda x: local_qr_safe(x, "tsqr", key=key),
                mesh=mesh,
                in_specs=PartitionSpec(ROWS),
                out_specs=(PartitionSpec(ROWS), PartitionSpec(), PartitionSpec()),
            )
        )(Xs)
        Q, R = np.asarray(Q), np.asarray(R)
        assert int(rank) == 4
        # Basis is full-rank orthonormal despite the deficiency.
        np.testing.assert_allclose(Q.T @ Q, np.eye(m), atol=1e-10)
        # Surviving columns still reproduce X's range: X columns lie in span(Q).
        proj = Q @ (Q.T @ X)
        np.testing.assert_allclose(proj, X, atol=1e-10)

    def test_local_qr_safe_full_rank_passthrough(self, mesh):
        from ca_lanczos_tpu.parallel.dist_orth import local_qr, local_qr_safe

        n, m = 512, 5
        X = np.random.default_rng(1).standard_normal((n, m))
        Xs = jax.device_put(jnp.asarray(X), jax.NamedSharding(mesh, PartitionSpec(ROWS)))
        key = jax.random.PRNGKey(3)
        Qs, Rs, rank = jax.jit(
            jax.shard_map(
                lambda x: local_qr_safe(x, "tsqr", key=key),
                mesh=mesh, in_specs=PartitionSpec(ROWS),
                out_specs=(PartitionSpec(ROWS), PartitionSpec(), PartitionSpec()),
            )
        )(Xs)
        Q0, R0 = jax.jit(
            jax.shard_map(
                lambda x: local_qr(x, "tsqr"),
                mesh=mesh, in_specs=PartitionSpec(ROWS),
                out_specs=(PartitionSpec(ROWS), PartitionSpec()),
            )
        )(Xs)
        assert int(rank) == m
        np.testing.assert_allclose(np.asarray(Qs), np.asarray(Q0), atol=1e-12)
        np.testing.assert_allclose(np.asarray(Rs), np.asarray(R0), atol=1e-12)

    def test_rank_deficient_block_converges(self, mesh):
        """Start vector = exact top eigenvector: the first powers block
        is rank-1; with safe_qr the distributed solve still converges
        (normalize.m:28-51 behavior, distributed)."""
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        r = np.zeros(n)
        r[-1] = 1.0  # exact eigenvector of the top eigenvalue
        cfg = LanczosConfig(s=4, basis=Basis.MONOMIAL, orth=Orth.LOCAL,
                            n_wanted=4, tol=1e-8)
        res = dist_restarted_ca_lanczos(A, r, 32, mesh, cfg, safe_qr=True)
        assert res.converged
        exact = np.linspace(1, 100, n)[::-1][:4]
        # A monomial/local run seeded ON an eigenvector is the worst case
        # for CA numerics (predicted residuals outrun true ones on the
        # ill-conditioned blocks); recovery must converge all wanted
        # pairs, with the exactly-invariant top pair at full accuracy.
        got = np.sort(res.eigs)[::-1]
        np.testing.assert_allclose(got, exact, rtol=1e-4)
        np.testing.assert_allclose(got[0], 100.0, rtol=1e-12)


class TestRowsNativePowers:
    def test_matches_column_api(self, mesh):
        from ca_lanczos_tpu.parallel import dist_matrix_powers_rows

        n, s = 256, 4
        A = laplacian_1d(n)
        Ad = DistDia.from_dia(A, mesh, s_max=s)
        x = np.random.default_rng(5).standard_normal(n)
        xs = Ad.shard_vector(x, mesh)
        z = jnp.zeros(s)
        V = np.asarray(dist_matrix_powers(Ad, xs, s, z, z, mesh))[:n]
        W = np.asarray(dist_matrix_powers_rows(Ad, xs, s, z, z, mesh))[:, :n]
        np.testing.assert_allclose(W.T, V[:, 1:], atol=1e-13)


class TestDistEllRandomBand:
    """Distributed general sparsity: random columns inside a band on the
    DistEll gather local step (reference seam SpMV.m:1-5)."""

    @staticmethod
    def _random_banded_ell(n, bw, nnz_per_row, seed):
        import scipy.sparse as sp
        from ca_lanczos_tpu.ops.spmv import EllMatrix

        rng = np.random.default_rng(seed)
        rows, cols, vals = [], [], []
        for i in range(n):
            lo, hi = max(0, i - bw), min(n, i + bw + 1)
            k = min(nnz_per_row, hi - lo)
            cs = rng.choice(np.arange(lo, hi), size=k, replace=False)
            rows += [i] * k
            cols += list(cs)
            vals += list(rng.standard_normal(k))
        a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
        a = a + a.T  # symmetric, general sparsity inside the band
        return EllMatrix.from_scipy(a.tocsr())

    @pytest.mark.parametrize("s", [1, 2, 4])
    def test_matches_single_chip(self, mesh, s):
        from ca_lanczos_tpu.parallel.dist_ell import DistEll, dist_ell_matrix_powers

        n = 512
        Aell = self._random_banded_ell(n, bw=8, nnz_per_row=5, seed=3)
        Adist = DistEll.from_ell(Aell, mesh, s_max=s)
        x = np.random.default_rng(7).standard_normal(n)
        xs = Adist.shard_vector(x, mesh)
        z = jnp.zeros(s)
        V = np.asarray(dist_ell_matrix_powers(Adist, xs, s, z, z, mesh))[:n]
        V_ref = np.asarray(matrix_powers(Aell, jnp.asarray(x), s, None, Basis.MONOMIAL))
        np.testing.assert_allclose(V, V_ref, rtol=1e-11, atol=1e-9)

    def test_newton_coeffs(self, mesh):
        from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_from_B
        from ca_lanczos_tpu.parallel.dist_ell import DistEll, dist_ell_matrix_powers

        n, s = 512, 4
        Aell = self._random_banded_ell(n, bw=8, nnz_per_row=5, seed=4)
        q = jnp.asarray(np.random.default_rng(8).standard_normal(n))
        Bk = build_basis_matrix(Aell, q / jnp.linalg.norm(q), s, Basis.NEWTON)
        diag, sub = newton_coeffs(Bk)
        Adist = DistEll.from_ell(Aell, mesh, s_max=s)
        xs = Adist.shard_vector(np.asarray(q), mesh)
        V = np.asarray(
            dist_ell_matrix_powers(Adist, xs, s, jnp.asarray(diag), jnp.asarray(sub), mesh)
        )[:n]
        V_ref = np.asarray(matrix_powers_from_B(Aell, q, Bk))
        np.testing.assert_allclose(V, V_ref, rtol=1e-11, atol=1e-9)

    def test_f64_state_through_f32_planes(self, mesh):
        """f32-plane DistEll with f64 driver STATE (the dist IRL's
        requirement) returns powers at the state dtype."""
        from ca_lanczos_tpu.ops.spmv import EllMatrix
        from ca_lanczos_tpu.parallel.dist_ell import (
            DistEll, dist_ell_matrix_powers,
        )

        n, s = 512, 2
        Aell = self._random_banded_ell(n, bw=8, nnz_per_row=5, seed=5)
        A32 = EllMatrix(vals=jnp.asarray(np.asarray(Aell.vals), jnp.float32),
                        cols=Aell.cols)
        Adist = DistEll.from_ell(A32, mesh, s_max=s)
        assert Adist.vals.dtype == jnp.float32
        x = np.random.default_rng(9).standard_normal(n)
        xs = Adist.shard_vector(x, mesh)
        assert xs.dtype == jnp.float64
        V = dist_ell_matrix_powers(Adist, xs, s, jnp.zeros(s), jnp.zeros(s),
                                   mesh)
        assert V.dtype == jnp.float64  # state dtype preserved
        V_ref = np.asarray(
            matrix_powers(A32, jnp.asarray(x, jnp.float32), s, None,
                          Basis.MONOMIAL)
        )
        np.testing.assert_allclose(np.asarray(V)[:n], V_ref, rtol=2e-4,
                                   atol=2e-4)

    def test_driver_parity(self, mesh):
        """dist_ca_lanczos on DistEll matches the single-device driver's
        Ritz values on a general ELL operator."""
        from ca_lanczos_tpu.ops.spmv import EllMatrix

        nx, ny = 8, 64
        Ad = laplacian_2d(nx, ny)
        A = EllMatrix.from_dense(np.asarray(Ad.to_dense()))
        n = nx * ny
        r = jnp.ones((n,), jnp.float64)
        s, steps = 4, 24
        res_d = dist_ca_lanczos(A, r, s, steps, mesh, basis=Basis.MONOMIAL)
        res_1 = ca_lanczos(A, r, s, steps, basis=Basis.MONOMIAL, orth=Orth.LOCAL)
        d_dist = np.sort(np.linalg.eigvalsh(res_d.T))
        d_one = np.sort(np.linalg.eigvalsh(res_1.T))
        np.testing.assert_allclose(d_dist, d_one, rtol=1e-8, atol=1e-8)

    def test_restarted_flagship_ell(self, mesh):
        """The distributed restarted flagship converges on the DistEll path."""
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.ops.spmv import EllMatrix
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        nx, ny = 8, 64
        Ad = laplacian_2d(nx, ny)
        A = EllMatrix.from_dense(np.asarray(Ad.to_dense()))
        n = nx * ny
        cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=Orth.LOCAL,
                            n_wanted=4, tol=1e-8)
        res = dist_restarted_ca_lanczos(A, np.ones(n), 32, mesh, cfg)
        assert res.converged
        dense = np.asarray(Ad.to_dense())
        exact = np.sort(np.linalg.eigvalsh(dense))[::-1][:4]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-9)
