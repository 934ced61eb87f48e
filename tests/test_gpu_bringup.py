"""What running on an NVIDIA GPU adds: full-precision products in the
orthogonalization, the compile-cache helper, the entry points' platform
handling and their refusal to measure without a card, plus the card-only
checks (``gpu`` marker)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dot_precisions(jaxpr):
    """Precision config of every dot_general in a jaxpr, sub-jaxprs
    included (pjit, scan, while, cond, shard_map bodies)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dot_precisions(inner))
    return out


def _assert_highest(fn, *args):
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "no dot_general traced"
    for p in precs:
        assert p is not None and all(
            q == jax.lax.Precision.HIGHEST for q in p
        ), precs


def _block(n=256, m=5, dtype=jnp.float32):
    return jnp.asarray(np.random.default_rng(0).standard_normal((n, m)), dtype)


class TestHighestPrecision:
    """Every orthogonalization product asks for full f32 precision (a GPU
    would otherwise run f32 matmuls in TF32)."""

    @pytest.mark.parametrize(
        "name", ["cholqr", "cholqr2", "cholqr_mp", "cholqr2_mp", "gram_f64"]
    )
    def test_qr_products(self, name):
        import ca_lanczos_tpu.ops.qr as qr

        fn = getattr(qr, name)
        X = _block()
        if name == "gram_f64":
            _assert_highest(fn, X, X)
        else:
            _assert_highest(fn, X)

    @pytest.mark.parametrize("name", ["_proj_block", "_proj_block_mp"])
    def test_cgs_projection(self, name):
        import ca_lanczos_tpu.ops.orth as orth

        Q, _ = jnp.linalg.qr(_block(m=3))
        _assert_highest(getattr(orth, name), Q, _block(m=4))

    @pytest.mark.parametrize("name", ["_cholqr2_rm", "_proj_rm", "_gram32_rm"])
    def test_polish_products(self, name):
        import ca_lanczos_tpu.solvers.polish as polish

        Z = _block(n=4, m=256)
        if name == "_cholqr2_rm":
            _assert_highest(polish._cholqr2_rm, Z)
        else:
            _assert_highest(getattr(polish, name), Z, Z)

    def test_fused_driver_cycle(self):
        from ca_lanczos_tpu.ops.spmv import DiaMatrix
        from ca_lanczos_tpu.solvers.fused_restarted import _make_cycle_body
        from ca_lanczos_tpu.solvers.ca_lanczos import monomial_basis_matrix

        n, s, k = 128, 4, 2
        A = DiaMatrix(data=jnp.ones((1, n), jnp.float32), offsets=(0,))
        body = _make_cycle_body(
            A, jnp.asarray(monomial_basis_matrix(s), jnp.float32),
            jnp.float32(1e-4), jnp.float32(1.0), s, 2, k, False,
        )
        state = (jnp.ones(n, jnp.float32), jnp.zeros((n, 2 * k), jnp.float32),
                 jnp.zeros(2 * k, jnp.float32), jnp.int32(0), jnp.int32(0))
        _assert_highest(body, state)

    @pytest.mark.parametrize("qr_method", ["tsqr", "cholqr2"])
    def test_distributed_block_orth(self, qr_method):
        from ca_lanczos_tpu.parallel import make_mesh
        from ca_lanczos_tpu.parallel.dist_orth import local_project, local_qr

        mesh = make_mesh(4)
        spec = PartitionSpec("rows")

        def step(Q, X):
            Y, _ = local_project(Q, X, passes=2)
            return local_qr(Y, qr_method)[0]

        fn = jax.shard_map(step, mesh=mesh, in_specs=(spec, spec),
                           out_specs=spec)
        _assert_highest(fn, _block(m=3), _block(m=4))


class TestCompileCache:
    def test_env_var_wins_and_sets_nothing(self, monkeypatch):
        from ca_lanczos_tpu.utils.cache import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
        assert enable_compile_cache() == "/some/where"
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_checkout_cache(self, monkeypatch):
        from ca_lanczos_tpu.utils.cache import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        try:
            path = enable_compile_cache()
            assert path == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


class TestCliPlatform:
    @pytest.mark.parametrize("platform", ["cpu", "gpu", "default"])
    def test_accepts(self, platform):
        from ca_lanczos_tpu.__main__ import build_parser

        args = build_parser().parse_args(["--platform", platform, "info"])
        assert args.platform == platform

    def test_default_keeps_environment_choice(self):
        from ca_lanczos_tpu.__main__ import build_parser

        assert build_parser().parse_args(["info"]).platform == "default"

    @pytest.mark.parametrize("platform", ["rocm", "cuda"])
    def test_rejects_unknown(self, platform):
        from ca_lanczos_tpu.__main__ import build_parser

        with pytest.raises(SystemExit):
            build_parser().parse_args(["--platform", platform, "info"])


class TestRefusesCpu:
    """Measuring entry points never carry on without a GPU and never
    print a result there."""

    @pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
    def test_exits_nonzero_without_ok_line(self, script):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        cp = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                            capture_output=True, text=True, timeout=300)
        assert cp.returncode != 0
        assert '"ok": true' not in cp.stdout
        assert "no GPU" in cp.stderr
        for line in cp.stdout.splitlines():
            with pytest.raises(json.JSONDecodeError):
                json.loads(line)


@pytest.mark.gpu
class TestOnCard:
    def test_matrix_powers_compiled(self, gpu):
        from ca_lanczos_tpu.config import Basis
        from ca_lanczos_tpu.ops.matrix_powers import matrix_powers
        from ca_lanczos_tpu.utils.matrices import laplacian_1d

        n, s = 1 << 16, 8
        A = laplacian_1d(n, dtype=jnp.float32)
        q = jnp.ones(n, jnp.float32) / np.sqrt(n)
        V = matrix_powers(A, q, s, None, Basis.MONOMIAL)
        assert V.devices() == {gpu}
        Ad = np.asarray(A.data, np.float64)
        W = np.asarray(q, np.float64)
        for k in range(s):
            W = Ad[1] * W + Ad[0] * np.concatenate([[0.0], W[:-1]]) \
                + Ad[2] * np.concatenate([W[1:], [0.0]])
        np.testing.assert_allclose(np.asarray(V[:, s]), W, rtol=1e-4, atol=1e-5)

    def test_cholqr2_full_f32_orthogonality(self, gpu):
        from ca_lanczos_tpu.ops.qr import cholqr2

        X = jnp.asarray(np.random.default_rng(0).standard_normal((1 << 20, 9)),
                        jnp.float32)
        Q, _ = cholqr2(X)
        Q64 = np.asarray(Q, np.float64)
        assert np.linalg.norm(Q64.T @ Q64 - np.eye(9), 2) < 1e-5
