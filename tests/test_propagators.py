"""Propagator parity tests (runLanczos.m model): propagate the harmonic-
oscillator Gaussian packet and compare against the dense matrix-exponential
oracle psi_ref = expm(-i t H) psi (runLanczos.m:30,211-213)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from ca_lanczos_tpu.config import Basis
from ca_lanczos_tpu.solvers.propagators import ca_lanczos_prop, lanczos_prop, propagate
from ca_lanczos_tpu.utils.matrices import gaussian_packet, harmonic_oscillator


@pytest.fixture(scope="module")
def ho():
    H, x = harmonic_oscillator(128, (-10.0, 10.0))
    psi = gaussian_packet(x)
    return H, jnp.asarray(psi, jnp.complex128)


class TestLanczosProp:
    def test_single_step_oracle(self, ho):
        H, psi = ho
        dt = 0.025
        res = lanczos_prop(H, psi, 24, dt)
        out = np.asarray(res.apply_exp(dt, float(jnp.linalg.norm(psi))))
        Hd = np.asarray(H.to_dense())
        ref = scipy.linalg.expm(-1j * dt * Hd) @ np.asarray(psi)
        assert np.max(np.abs(out - ref)) < 1e-10

    def test_adaptive_stops_early(self, ho):
        H, psi = ho
        res = lanczos_prop(H, psi, 40, 0.025, tol=1e-10, adaptive=True)
        assert res.n_steps < 40
        assert res.residual < 1e-10


class TestCaLanczosProp:
    @pytest.mark.parametrize("basis", [Basis.MONOMIAL, Basis.NEWTON])
    def test_single_step_oracle(self, ho, basis):
        H, psi = ho
        dt = 0.025
        res = ca_lanczos_prop(H, psi, s=6, m=4, dt=dt, basis=basis)
        assert res.n_steps == 24
        out = np.asarray(res.apply_exp(dt, float(jnp.linalg.norm(psi))))
        Hd = np.asarray(H.to_dense())
        ref = scipy.linalg.expm(-1j * dt * Hd) @ np.asarray(psi)
        # The monomial basis loses ~log10(||H||^s) digits to conditioning
        # (the reason the reference defaults to newton, runLanczos.m:96).
        tol = 1e-6 if basis == Basis.MONOMIAL else 1e-9
        assert np.max(np.abs(out - ref)) < tol

    def test_eigest_skips_bootstrap(self, ho):
        H, psi = ho
        eigest = np.linspace(0.5, 40.0, 12)  # rough spectral estimates
        res = ca_lanczos_prop(H, psi, s=6, m=4, dt=0.025, eigest=eigest)
        out = np.asarray(res.apply_exp(0.025, float(jnp.linalg.norm(psi))))
        Hd = np.asarray(H.to_dense())
        ref = scipy.linalg.expm(-1j * 0.025 * Hd) @ np.asarray(psi)
        assert np.max(np.abs(out - ref)) < 1e-9


class TestPropagateLoop:
    """Multi-step propagation: the runLanczos.m experiment at reduced size
    (20 steps instead of 200; N=128)."""

    @pytest.mark.parametrize(
        "method,basis",
        [("lanczos", Basis.NEWTON), ("ca", Basis.NEWTON), ("ca", Basis.MONOMIAL)],
    )
    def test_vs_expm(self, ho, method, basis):
        H, psi = ho
        dt, n_steps = 0.025, 20
        out = np.asarray(
            propagate(H, psi, dt, n_steps, krylov_dim=24, method=method, s=6, basis=basis)
        )
        Hd = np.asarray(H.to_dense())
        ref = scipy.linalg.expm(-1j * dt * n_steps * Hd) @ np.asarray(psi)
        # runLanczos.m error metric: max |psi_ref - psi| (runLanczos.m:211-213)
        assert np.max(np.abs(out - ref)) < 1e-8

    def test_norm_conserved(self, ho):
        H, psi = ho
        out = propagate(H, psi, 0.025, 10, krylov_dim=24, method="ca", s=6)
        np.testing.assert_allclose(
            float(jnp.linalg.norm(out)), float(jnp.linalg.norm(psi)), rtol=1e-10
        )


class TestSplitPath:
    """Real/imag-split propagation (the all-real path) must match the
    complex path to roundoff."""

    def test_matches_complex(self, ho):
        """Early-step T entries agree to roundoff (once the Krylov space
        converges, eps-level reduction-order differences diverge the
        trajectories — both stay accurate, see the oracle test)."""
        from ca_lanczos_tpu.solvers.propagators import lanczos_prop_split

        H, psi = ho
        dt = 0.025
        res_c = lanczos_prop(H, psi, 20, dt)
        res_s = lanczos_prop_split(H, psi, 20, dt)
        np.testing.assert_allclose(res_s.T[:8, :8], res_c.T[:8, :8], atol=1e-10)
        out_c = np.asarray(res_c.apply_exp(dt, float(jnp.linalg.norm(psi))))
        out_s = np.asarray(res_s.apply_exp(dt, float(jnp.linalg.norm(psi))))
        out_s = out_s[:, 0] + 1j * out_s[:, 1]
        np.testing.assert_allclose(out_s, out_c, atol=1e-10)

    def test_propagate_split_vs_expm(self, ho):
        import scipy.linalg

        from ca_lanczos_tpu.solvers.propagators import propagate_split

        H, psi = ho
        dt, n_steps = 0.025, 10
        out = propagate_split(H, psi, dt, n_steps, krylov_dim=24)
        Hd = np.asarray(H.to_dense())
        ref = scipy.linalg.expm(-1j * dt * n_steps * Hd) @ np.asarray(psi)
        assert np.max(np.abs(out - ref)) < 1e-9

    def test_ca_split_vs_oracle(self, ho):
        import scipy.linalg

        from ca_lanczos_tpu.solvers.propagators import ca_lanczos_prop_split

        H, psi = ho
        dt = 0.025
        res = ca_lanczos_prop_split(H, psi, s=6, m=4, dt=dt)
        assert res.n_steps == 24
        out = np.asarray(res.apply_exp(dt, float(jnp.linalg.norm(psi))))
        out = out[:, 0] + 1j * out[:, 1]
        Hd = np.asarray(H.to_dense())
        ref = scipy.linalg.expm(-1j * dt * Hd) @ np.asarray(psi)
        assert np.max(np.abs(out - ref)) < 1e-9

    def test_ca_split_residual_adaptive(self, ho):
        from ca_lanczos_tpu.solvers.propagators import ca_lanczos_prop_split

        H, psi = ho
        res = ca_lanczos_prop_split(H, psi, s=6, m=6, dt=0.025, tol=1e-10, adaptive=True)
        assert res.n_steps < 36
        assert res.residual < 1e-10

    def test_fused_one_call_vs_expm(self, ho):
        import scipy.linalg

        from ca_lanczos_tpu.solvers.propagators import propagate_split_fused

        H, psi = ho
        dt, n_steps = 0.025, 20
        out = propagate_split_fused(H, psi, dt, n_steps, krylov_dim=24)
        Hd = np.asarray(H.to_dense())
        ref = scipy.linalg.expm(-1j * dt * n_steps * Hd) @ np.asarray(psi)
        assert np.max(np.abs(out - ref)) < 1e-12


class TestFusedAdaptive:
    """On-device adaptive residual for the fused propagator (VERDICT
    round-1 item 10; reference lanczos_prop.m:44-55)."""

    def test_matches_host_adaptive_and_step_counts(self):
        import jax.numpy as jnp
        from ca_lanczos_tpu.solvers.propagators import (
            _to_split,
            lanczos_prop_split,
            propagate_split_fused_steps,
        )
        from ca_lanczos_tpu.utils.matrices import gaussian_packet, harmonic_oscillator

        n, dt, steps, m, tol = 128, 0.025, 8, 24, 1e-10
        H, x = harmonic_oscillator(n)
        psi0 = gaussian_packet(x).astype(np.complex128)

        psi_f, total_f = propagate_split_fused_steps(
            H, psi0, dt, steps, krylov_dim=m, tol=tol
        )

        psi_h = _to_split(psi0)
        total_h = 0
        for _ in range(steps):
            nrm = float(jnp.sqrt(jnp.sum(psi_h * psi_h)))
            res = lanczos_prop_split(H, psi_h, m, dt, tol, adaptive=True)
            total_h += res.n_steps
            psi_h = res.apply_exp(dt, nrm)
        psi_h = np.asarray(psi_h[:, 0] + 1j * psi_h[:, 1])

        assert total_f == total_h, (total_f, total_h)
        assert total_f < steps * m  # the early exit actually fired
        np.testing.assert_allclose(psi_f, psi_h, atol=1e-9)

    def test_tight_tol_matches_fixed_depth(self):
        from ca_lanczos_tpu.solvers.propagators import propagate_split_fused
        from ca_lanczos_tpu.utils.matrices import gaussian_packet, harmonic_oscillator

        n, dt, steps, m = 128, 0.025, 5, 16
        H, x = harmonic_oscillator(n)
        psi0 = gaussian_packet(x).astype(np.complex128)
        psi_fix = propagate_split_fused(H, psi0, dt, steps, krylov_dim=m)
        psi_ad = propagate_split_fused(
            H, psi0, dt, steps, krylov_dim=m, adaptive=True, tol=1e-300
        )
        np.testing.assert_allclose(psi_ad, psi_fix, atol=1e-12)
