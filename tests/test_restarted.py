"""Restarted-driver parity tests (test_restart_diagonal_matrices.m model):
diagonal matrices with exactly-known spectra; converged eigenvalues must
match the analytic top of the spectrum within the driver tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest

from ca_lanczos_tpu.config import Basis, LanczosConfig, Orth
from ca_lanczos_tpu.solvers.restarted import restarted_ca_lanczos, restarted_lanczos
from ca_lanczos_tpu.utils.matrices import diag_spectrum, laplacian_2d


def _exact_top(n, lo, hi, k):
    return np.linspace(lo, hi, n)[::-1][:k]


class TestRestartedLanczos:
    @pytest.mark.parametrize("orth", [Orth.LOCAL, Orth.FULL, Orth.PERIODIC, Orth.SELECTIVE])
    def test_diagonal(self, orth):
        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        r = jnp.ones((n,), jnp.float64)
        res = restarted_lanczos(A, r, max_lanczos=30, n_wanted=6, orth=orth, tol=1e-8)
        assert res.converged
        exact = _exact_top(n, 1.0, 100.0, 6)
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-6)

    def test_residuals_returned(self):
        n = 300
        A = diag_spectrum(n, 1.0, 50.0)
        r = jnp.ones((n,), jnp.float64)
        res = restarted_lanczos(A, r, max_lanczos=24, n_wanted=4, orth=Orth.FULL)
        assert res.conv_rnorms.shape == (4,)
        assert res.orth_err.shape == (res.n_restarts,)
        # Full orth keeps the basis numerically orthonormal.
        assert np.max(res.orth_err) < 1e-8


class TestRestartedCaLanczos:
    @pytest.mark.parametrize("orth", [Orth.LOCAL, Orth.FULL, Orth.PERIODIC, Orth.SELECTIVE])
    @pytest.mark.parametrize("basis", [Basis.MONOMIAL, Basis.NEWTON])
    def test_diagonal(self, orth, basis):
        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        r = jnp.ones((n,), jnp.float64)
        cfg = LanczosConfig(s=4, basis=basis, orth=orth, n_wanted=6, tol=1e-8)
        res = restarted_ca_lanczos(A, r, max_lanczos=32, config=cfg)
        assert res.converged, f"did not converge in {res.n_restarts} restarts"
        exact = _exact_top(n, 1.0, 100.0, 6)
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-6)

    def test_flagship_config(self):
        """North-star defaults: s=6, newton, local, tol=1e-8
        (restarted_ca_lanczos.m:13-39)."""
        n = 500
        A = diag_spectrum(n, 1.0, 100.0)
        r = jnp.ones((n,), jnp.float64)
        cfg = LanczosConfig()  # s=6, newton, local, n_wanted=10
        res = restarted_ca_lanczos(A, r, max_lanczos=60, config=cfg)
        assert res.converged
        exact = _exact_top(n, 1.0, 100.0, 10)
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-6)
        # Residuals at lock time satisfy the scaled tolerance.
        assert np.max(res.conv_rnorms) < 1e-8 * 100.0 * 1.01

    def test_laplacian_2d(self):
        """General (non-diagonal) operator: 2-D Laplacian, eigenvalues
        known analytically: 4 - 2cos(i pi h) - 2cos(j pi h)."""
        nx = ny = 20
        A = laplacian_2d(nx, ny)
        n = nx * ny
        iv = np.pi * np.arange(1, nx + 1) / (nx + 1)
        lam = 2 - 2 * np.cos(iv)
        exact = np.sort(np.add.outer(lam, lam).ravel())[::-1][:4]
        r = jnp.asarray(np.random.default_rng(3).standard_normal(n))
        cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=Orth.FULL, n_wanted=4, tol=1e-9)
        res = restarted_ca_lanczos(A, r, max_lanczos=40, config=cfg)
        assert res.converged
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-7)


class TestCanonicalConfig:
    @pytest.mark.slow
    def test_reference_restart_diagonal(self):
        """The reference's canonical restart experiment
        (test_restart_diagonal_matrices.m:8-28): N=5000,
        diag(linspace(1,1e4,N)), maxvecs=60, 10 wanted eigs, full orth,
        tol=1e-8*normest(A); converged eigenvalues must match the exact
        top of the spectrum."""
        n = 5000
        A = diag_spectrum(n, 1.0, 1e4)
        r = jnp.asarray(np.random.default_rng(0).random(n))
        cfg = LanczosConfig(s=6, basis=Basis.NEWTON, orth=Orth.FULL, n_wanted=10, tol=1e-8)
        res = restarted_ca_lanczos(A, r, 60, cfg)
        assert res.converged
        exact = np.linspace(1.0, 1e4, n)[::-1][:10]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, atol=1e-7)
        # Residuals satisfy the scaled tolerance (tol * normest ~ 1e-4).
        assert np.max(res.conv_rnorms) < 1e-4


class TestRestartStrategies:
    """Restart-vector strategies (restarted_ca_lanczos.m:204-248) steer
    WHICH pairs converge: 'largest' drives the top of the spectrum,
    'smallest' the bottom; 'closest_conv'/'random' lock whatever
    converges (all locked values must be genuine eigenvalues)."""

    def _run(self, strategy, max_restarts=60):
        from ca_lanczos_tpu.config import RestartStrategy

        n = 300
        A = diag_spectrum(n, 1.0, 60.0)
        r = jnp.ones((n,), jnp.float64)
        cfg = LanczosConfig(
            s=4, basis=Basis.NEWTON, orth=Orth.FULL, n_wanted=4, tol=1e-8,
            restart_strategy=RestartStrategy(strategy), max_restarts=max_restarts,
        )
        return restarted_ca_lanczos(A, r, 32, cfg), np.linspace(1.0, 60.0, n)

    def test_largest(self):
        res, d = self._run("largest")
        assert res.converged
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], d[::-1][:4], rtol=1e-7)

    def test_smallest(self):
        res, d = self._run("smallest")
        assert res.converged
        np.testing.assert_allclose(np.sort(res.eigs), d[:4], rtol=1e-7)

    @pytest.mark.parametrize("strategy", ["closest_conv", "random"])
    def test_locked_values_are_eigenvalues(self, strategy):
        res, d = self._run(strategy, max_restarts=30)
        # Whatever locked must match SOME exact eigenvalue closely.
        for lam in res.eigs:
            assert np.min(np.abs(d - lam)) < 1e-6 * 60.0


class TestFusedRestarted:
    def test_one_call_solver_matches_exact(self):
        from ca_lanczos_tpu.solvers.fused_restarted import fused_restarted_ca_lanczos

        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        res = fused_restarted_ca_lanczos(
            A, jnp.ones(n), 32, n_wanted=6, s=4, basis=Basis.NEWTON,
            tol=1e-8, max_restarts=60,
        )
        assert res.converged
        exact = np.linspace(1.0, 100.0, n)[::-1][:6]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-9)
        Q = np.asarray(res.Q_conv)
        np.testing.assert_allclose(Q.T @ Q, np.eye(6), atol=1e-10)

    def test_cycles_per_call_matches_single_call(self):
        """Bounded burst mode runs the same cycle transition: results
        are bit-identical to the one-call while_loop, and on_burst sees
        monotone (cycle, nconv) progress at the burst boundary."""
        from ca_lanczos_tpu.solvers.fused_restarted import fused_restarted_ca_lanczos

        n = 400
        A = diag_spectrum(n, 1.0, 100.0)
        kw = dict(n_wanted=6, s=4, basis=Basis.NEWTON, tol=1e-8, max_restarts=60)
        r1 = fused_restarted_ca_lanczos(A, jnp.ones(n), 32, **kw)
        seen = []
        r2 = fused_restarted_ca_lanczos(
            A, jnp.ones(n), 32, cycles_per_call=2,
            on_burst=lambda c, k: seen.append((c, k)), **kw,
        )
        assert r2.converged and r2.n_restarts == r1.n_restarts
        np.testing.assert_array_equal(np.sort(r2.eigs), np.sort(r1.eigs))
        np.testing.assert_allclose(
            np.asarray(r2.Q_conv), np.asarray(r1.Q_conv), atol=0
        )
        cycles = [c for c, _ in seen]
        assert cycles == sorted(cycles) and max(cycles) == r1.n_restarts
        assert all(b - a <= 2 for a, b in zip(cycles, cycles[1:]))
        assert seen[-1][1] == 6

    def test_monomial_basis(self):
        from ca_lanczos_tpu.solvers.fused_restarted import fused_restarted_ca_lanczos

        n = 300
        A = diag_spectrum(n, 1.0, 60.0)
        res = fused_restarted_ca_lanczos(
            A, jnp.ones(n), 24, n_wanted=4, s=4, basis=Basis.MONOMIAL,
            tol=1e-8, max_restarts=80,
        )
        assert res.converged
        exact = np.linspace(1.0, 60.0, n)[::-1][:4]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-8)


class TestEllOperator:
    def test_flagship_on_ell(self):
        """The host flagship accepts any Operator format — harmonic
        oscillator Hamiltonian (ELL with periodic wrap)."""
        from ca_lanczos_tpu.utils.matrices import harmonic_oscillator

        H, _ = harmonic_oscillator(128)
        cfg = LanczosConfig(s=4, basis=Basis.NEWTON, orth=Orth.FULL, n_wanted=4, tol=1e-9)
        res = restarted_ca_lanczos(H, jnp.ones(128, jnp.float64), 32, cfg)
        assert res.converged
        exact = np.sort(np.linalg.eigvalsh(np.asarray(H.to_dense())))[::-1][:4]
        np.testing.assert_allclose(np.sort(res.eigs)[::-1], exact, rtol=1e-8)


class TestWantedEndStop:
    """Round-4 regression: the stop criterion must not count converged
    WRONG-END pairs toward n_wanted (the reference's committed code does,
    restarted_ca_lanczos.m:262-266; its commented-out block :255-261 is
    the intent we implement).  Fixture: well-separated BOTTOM end + a
    tight TOP cluster, so bottom pairs converge first."""

    def _op(self, n=3000):
        d = np.linspace(0.0, 1.0, n)
        d[:3] = [-6.0, -5.0, -4.0]          # separated bottom end
        d[-6:] = 1.0 + np.arange(6) * 1e-3  # tight top cluster
        return diag_spectrum_from(d), np.sort(d)[::-1]

    def test_restarted_ca_returns_wanted_end(self):
        A, exact = self._op()
        cfg = LanczosConfig(n_wanted=4, s=4, tol=1e-7, max_restarts=200,
                            orth=Orth.FULL)
        res = restarted_ca_lanczos(A, jnp.ones(3000), 24, cfg)
        assert res.converged
        got = np.sort(np.asarray(res.eigs))[::-1][:4]
        np.testing.assert_allclose(got, exact[:4], atol=1e-7)
        assert np.all(got > 0.9), got  # no bottom-end value reported

    def test_restarted_std_returns_wanted_end(self):
        A, exact = self._op()
        res = restarted_lanczos(A, jnp.ones(3000), 24, n_wanted=4,
                                tol=1e-7, max_restarts=200, orth=Orth.FULL)
        assert res.converged
        got = np.sort(np.asarray(res.eigs))[::-1][:4]
        np.testing.assert_allclose(got, exact[:4], atol=1e-7)
        assert np.all(got > 0.9), got


class TestSmallestEnd:
    """ADVICE r4 medium regression: a restart_strategy=SMALLEST run must
    return the SMALLEST-end pairs — _finalize and the dist overfill trim
    used to sort descending and return incidentally-locked top-end pairs
    with converged=True.  Fixture mirrors TestWantedEndStop with the ends
    swapped: separated TOP end (converges first) + tight BOTTOM cluster."""

    def _op(self, n=3000):
        d = np.linspace(0.0, 1.0, n)
        d[-3:] = [4.0, 5.0, 6.0]            # separated top end
        d[:6] = -1.0 - np.arange(6) * 1e-3  # tight bottom cluster
        return diag_spectrum_from(d), np.sort(d)

    def test_restarted_ca_returns_smallest_end(self):
        from ca_lanczos_tpu.config import RestartStrategy

        A, exact = self._op()
        cfg = LanczosConfig(n_wanted=4, s=4, tol=1e-7, max_restarts=200,
                            orth=Orth.FULL,
                            restart_strategy=RestartStrategy.SMALLEST)
        res = restarted_ca_lanczos(A, jnp.ones(3000), 24, cfg)
        assert res.converged
        got = np.sort(np.asarray(res.eigs))[:4]
        np.testing.assert_allclose(got, exact[:4], atol=1e-7)
        assert np.all(got < 0.0), got  # no top-end value reported

    def test_restarted_std_returns_smallest_end(self):
        from ca_lanczos_tpu.config import RestartStrategy

        A, exact = self._op()
        res = restarted_lanczos(A, jnp.ones(3000), 24, n_wanted=4,
                                tol=1e-7, max_restarts=200, orth=Orth.FULL,
                                restart_strategy=RestartStrategy.SMALLEST)
        assert res.converged
        got = np.sort(np.asarray(res.eigs))[:4]
        np.testing.assert_allclose(got, exact[:4], atol=1e-7)
        assert np.all(got < 0.0), got


def diag_spectrum_from(d):
    from ca_lanczos_tpu.ops.spmv import DiaMatrix

    return DiaMatrix(data=jnp.asarray(np.asarray(d, np.float64)[None, :]),
                     offsets=(0,))
