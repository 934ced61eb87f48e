"""Checkpoint/resume and roofline audit tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from ca_lanczos_tpu.config import LanczosConfig, Orth
from ca_lanczos_tpu.solvers.restarted import restarted_ca_lanczos
from ca_lanczos_tpu.utils.checkpoint import RestartCheckpoint
from ca_lanczos_tpu.utils.matrices import diag_spectrum, laplacian_1d
from ca_lanczos_tpu.utils.profiling import (
    measure_powers_throughput, peak_hbm_bw, roofline_audit,
)


class TestCheckpoint:
    def test_resume_matches_uninterrupted(self, tmp_path):
        n = 300
        A = diag_spectrum(n, 1.0, 60.0)
        r = jnp.ones((n,), jnp.float64)
        cfg = LanczosConfig(s=4, orth=Orth.LOCAL, n_wanted=6, tol=1e-8)
        ckpt = str(tmp_path / "state.npz")

        # Uninterrupted run.
        full = restarted_ca_lanczos(A, r, 24, cfg)

        # Interrupted run: stop after 3 restarts, then resume.
        cfg3 = LanczosConfig(s=4, orth=Orth.LOCAL, n_wanted=6, tol=1e-8, max_restarts=3)
        part = restarted_ca_lanczos(A, r, 24, cfg3, checkpoint_path=ckpt)
        assert not part.converged
        resumed = restarted_ca_lanczos(A, r, 24, cfg, resume_from=ckpt)
        assert resumed.converged
        np.testing.assert_allclose(np.sort(resumed.eigs), np.sort(full.eigs), rtol=1e-10)
        assert resumed.n_restarts == full.n_restarts

    def test_checkpoint_roundtrip(self, tmp_path):
        ck = RestartCheckpoint(
            n_restarts=2,
            nconv=1,
            conv_eigs=[5.0],
            conv_rnorms=[1e-9],
            orth_err=[1e-12, 2e-12],
            rnorm_rows=[np.array([1e-9, np.nan])],
            Q_conv=np.ones((10, 1)),
            q=np.arange(10.0),
            Bk=np.eye(5)[:, 1:],
            rng_state=np.random.default_rng(7).bit_generator.state,
        )
        path = str(tmp_path / "ck.npz")
        ck.save(path)
        back = RestartCheckpoint.load(path)
        assert back.n_restarts == 2 and back.nconv == 1
        np.testing.assert_array_equal(back.q, ck.q)
        np.testing.assert_array_equal(back.Q_conv, ck.Q_conv)
        assert back.rng_state == ck.rng_state


class TestRoofline:
    def test_audit_model(self):
        A = laplacian_1d(4096, dtype=jnp.float32)
        rep = roofline_audit(A, measured_nnz_per_s=1e9,
                             hbm_bw=peak_hbm_bw("NVIDIA H100 80GB HBM3"))
        assert rep.nnz == 3 * 4096
        # DIA traffic: (3 + 2) * n * 4 bytes.
        assert rep.bytes_per_step == 5 * 4096 * 4
        assert 0 < rep.fraction_of_peak < 1
        assert "speed of light" in str(rep)

    def test_measure_runs_on_cpu(self):
        A = laplacian_1d(2048, dtype=jnp.float32)
        rate = measure_powers_throughput(A, s=2, reps=3, trials=1)
        assert rate > 0

    def test_ca_iteration_throughput_runs(self):
        from ca_lanczos_tpu.utils.profiling import measure_ca_iteration_throughput

        A = laplacian_1d(2048, dtype=jnp.float32)
        rate = measure_ca_iteration_throughput(A, s=2, blocks=3, trials=1)
        assert rate > 0

    def test_peak_table_rejects_unknown_device(self):
        """A device missing from the peak table is an error, not a
        default (and the CPU is not in it)."""
        with pytest.raises(KeyError, match="no published memory bandwidth"):
            peak_hbm_bw("cpu")
        with pytest.raises(KeyError):
            roofline_audit(laplacian_1d(64), hbm_bw=None)

    def test_peak_table_h100(self):
        assert peak_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12

    def test_copy_bandwidth_runs_on_cpu(self):
        from ca_lanczos_tpu.utils.profiling import measure_copy_bandwidth

        assert measure_copy_bandwidth(jnp.ones(4096, jnp.float32), reps=3,
                                      trials=1) > 0
