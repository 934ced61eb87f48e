"""Hierarchical (host x chip) mesh: the 2-level topology of a multi-host
run (SURVEY.md section 2b, multi-host runtime row; round-4 VERDICT
item 1).

The 2x4 virtual mesh here is the code path a 2-host x 4-card run takes:
rows shard host-major over BOTH axes, the halo ring crosses hosts only
at host boundaries, reductions are chip-level (intra-host) then
host-level (inter-host), and TSQR builds a genuinely two-level R tree.
Every engine must produce the SAME answers as the flat ('rows',) mesh
and the single-chip host drivers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import NamedSharding, PartitionSpec

from ca_lanczos_tpu.config import LanczosConfig
from ca_lanczos_tpu.ops.spmv import DiaMatrix, EllMatrix
from ca_lanczos_tpu.parallel import (
    CHIP,
    HOST,
    DistDia,
    dist_ca_lanczos,
    dist_matrix_powers,
    dist_restarted_ca_lanczos,
    local_tsqr,
    make_hier_mesh,
    make_mesh,
    psum_rows,
    row_axes,
    row_spec,
)
from ca_lanczos_tpu.solvers.ca_lanczos import ca_lanczos
from ca_lanczos_tpu.utils.matrices import laplacian_1d

from tests.test_comm_model import collective_bytes


@pytest.fixture(scope="module")
def hier():
    """2 hosts x 4 chips (virtual)."""
    return make_hier_mesh(2, 4)


@pytest.fixture(scope="module")
def flat():
    return make_mesh(8)


def _ritz_parity(res_dist, A_host, r_host, s, steps, tag, rtol=5e-4):
    host = ca_lanczos(A_host, jnp.asarray(r_host), s, steps)
    want = np.linalg.eigvalsh(np.asarray(host.T, np.float64))
    got = np.linalg.eigvalsh(np.asarray(res_dist.T, np.float64))
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=rtol,
        err_msg=f"{tag}: hier-mesh Ritz spectrum diverges from host oracle",
    )


class TestHierCollectives:
    def test_row_axes(self, hier, flat):
        assert row_axes(flat) == "rows"
        assert row_axes(hier) == (HOST, CHIP)

    def test_psum_rows_matches_flat(self, hier, flat):
        """Two-level psum (chip then host) == flat all-reduce."""
        x = np.arange(8.0 * 3).reshape(8, 3)

        def run(mesh):
            axes = row_axes(mesh)
            xs = jax.device_put(
                jnp.asarray(x), NamedSharding(mesh, row_spec(mesh))
            )
            return np.asarray(
                jax.shard_map(
                    lambda xl: psum_rows(xl, axes), mesh=mesh,
                    in_specs=row_spec(mesh), out_specs=row_spec(mesh),
                )(xs)
            )

        np.testing.assert_allclose(run(hier), run(flat))

    def test_hier_tsqr_two_level(self, hier):
        """Two-level TSQR: exact QR, sign-fixed R, and the R-tree psums
        are chip-level (C*m x m over CHIP) then host-level (H*m x m over
        HOST) — the inter-host reduction carries H small factors, not P."""
        n, m = 8 * 64, 5
        rng = np.random.default_rng(0)
        X = rng.standard_normal((n, m))
        Xs = jax.device_put(
            jnp.asarray(X), NamedSharding(hier, row_spec(hier))
        )
        axes = row_axes(hier)
        fn = jax.shard_map(
            lambda xl: local_tsqr(xl, axes), mesh=hier,
            in_specs=row_spec(hier),
            out_specs=(row_spec(hier), PartitionSpec()),
        )
        Q, R = fn(Xs)
        Q, R = np.asarray(Q), np.asarray(R)
        assert np.allclose(Q @ R, X, atol=1e-12)
        assert np.allclose(Q.T @ Q, np.eye(m), atol=1e-12)
        assert np.all(np.diag(R) >= 0)

        # Structural check from the lowered jaxpr: the stacked-R psums
        # (primitive `psum_invariant`) must be one chip-level (C*m, m)
        # reduction and one host-level (H*m, m) reduction.
        jx = jax.make_jaxpr(fn)(Xs)
        levels = []

        def walk(jaxpr):
            for eq in jaxpr.eqns:
                if eq.primitive.name.startswith("psum"):
                    for v in eq.invars:
                        if hasattr(v.aval, "shape") and len(v.aval.shape) == 2:
                            levels.append(
                                (tuple(eq.params["axes"]), tuple(v.aval.shape))
                            )
                for v in eq.params.values():
                    for sub in jax.tree_util.tree_leaves(
                        v, is_leaf=lambda t: hasattr(t, "eqns") or hasattr(t, "jaxpr")
                    ):
                        if hasattr(sub, "jaxpr"):
                            sub = sub.jaxpr
                        if hasattr(sub, "eqns"):
                            walk(sub)

        walk(jx.jaxpr)
        assert ((CHIP,), (4 * m, m)) in levels, levels
        assert ((HOST,), (2 * m, m)) in levels, levels

    def test_halo_ring_dcn_boundary_only(self, hier):
        """The halo ppermute's permutation pairs, partitioned by the
        host-major linear layout: exactly 2 pairs cross the host boundary
        (fwd 3->4, bwd 4->3 on a 2x4 mesh) — the minimum inter-host traffic for
        a ring — and total volume stays 2*halo*itemsize per device."""
        n, s = 8 * 512, 4
        A = DistDia.from_dia(laplacian_1d(n, dtype=jnp.float32), hier, s_max=s)
        x = A.shard_vector(np.ones(n, np.float32), hier)
        z = jnp.zeros(s, jnp.float32)

        jx = jax.make_jaxpr(
            lambda xx: dist_matrix_powers(A, xx, s, z, z, hier)
        )(x)
        perms = []

        def walk(jaxpr):
            for eq in jaxpr.eqns:
                if eq.primitive.name == "ppermute":
                    perms.append(eq.params["perm"])
                for v in eq.params.values():
                    for sub in jax.tree_util.tree_leaves(
                        v, is_leaf=lambda t: hasattr(t, "eqns") or hasattr(t, "jaxpr")
                    ):
                        if hasattr(sub, "jaxpr"):
                            sub = sub.jaxpr
                        if hasattr(sub, "eqns"):
                            walk(sub)

        walk(jx.jaxpr)
        assert len(perms) == 2  # one fwd + one bwd exchange per block
        C = 4
        cross = [
            (a, b) for perm in perms for a, b in perm if a // C != b // C
        ]
        assert len(cross) == 2, cross  # only the host-boundary pairs
        total, _ = collective_bytes(
            lambda xx: dist_matrix_powers(A, xx, s, z, z, hier), x
        )
        assert total == 2 * A.halo * 4


class TestHierParity:
    """Every engine on the 2x4 hierarchical mesh reproduces the host
    driver's spectrum (the dryrun's Ritz-parity contract, extended to
    the hierarchical topology)."""

    def test_powers_parity_vs_flat(self, hier, flat):
        n, s = 8 * 256, 4
        A = laplacian_1d(n, dtype=jnp.float32)
        r = np.random.default_rng(0).standard_normal(n).astype(np.float32)
        out = {}
        for tag, mesh in (("flat", flat), ("hier", hier)):
            Ad = DistDia.from_dia(A, mesh, s_max=s)
            x = Ad.shard_vector(r, mesh)
            z = jnp.zeros(s, x.dtype)
            out[tag] = np.asarray(dist_matrix_powers(Ad, x, s, z, z, mesh))[:n]
        np.testing.assert_allclose(out["flat"], out["hier"], rtol=1e-6)

    def test_ca_lanczos_natural(self, hier):
        n, s = 8 * 256, 4
        A = laplacian_1d(n, dtype=jnp.float32)
        r = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        res = dist_ca_lanczos(A, r, s, 2 * s, hier)
        _ritz_parity(res, A, r, s, 2 * s, "natural")

    def test_ca_lanczos_large_shards(self, hier):
        n, s = 8 * 1024, 4
        A = laplacian_1d(n, dtype=jnp.float32)
        r = np.random.default_rng(2).standard_normal(n).astype(np.float32)
        res = dist_ca_lanczos(A, r, s, 2 * s, hier)
        _ritz_parity(res, A, r, s, 2 * s, "large-shard DistDia")
        assert res.Q.shape == (n, 2 * s)

    def test_ca_lanczos_ell(self, hier):
        n, s = 8 * 64, 4
        rng = np.random.default_rng(3)
        g = sp.diags(
            [np.full(n, 2.0), np.full(n - 1, -1.0), np.full(n - 1, -1.0),
             0.1 * rng.random(n - 7), 0.1 * rng.random(n - 7)],
            [0, -1, 1, 7, -7],
        ).tocsr()
        g = ((g + g.T) / 2).astype(np.float32)
        A = EllMatrix.from_scipy(g)
        r = rng.standard_normal(n).astype(np.float32)
        res = dist_ca_lanczos(A, r, s, 2 * s, hier)
        _ritz_parity(res, A, r, s, 2 * s, "DistEll")

    def test_restarted_planted_spectrum(self, hier):
        n, s = 8 * 128, 4
        top = np.array([20.0, 22.0, 25.0], np.float32)
        d = np.linspace(1.0, 10.0, n).astype(np.float32)
        d[-3:] = top
        A = DiaMatrix(data=jnp.asarray(d[None, :]), offsets=(0,))
        cfg = LanczosConfig(s=s, n_wanted=3, tol=1e-4, max_restarts=30)
        r = np.random.default_rng(4).standard_normal(n).astype(np.float32)
        res = dist_restarted_ca_lanczos(A, r, 16, hier, cfg)
        assert res.converged
        np.testing.assert_allclose(
            np.sort(np.asarray(res.eigs))[::-1], np.sort(top)[::-1], rtol=1e-3
        )

    @pytest.mark.slow
    def test_irl_planted_spectrum(self, hier):
        from ca_lanczos_tpu.parallel.dist_irl import (
            dist_impl_restarted_ca_lanczos,
        )

        n, s = 8 * 128, 4
        top = np.array([20.0, 25.0], np.float32)
        d = np.linspace(1.0, 10.0, n).astype(np.float32)
        d[-2:] = top
        A = DiaMatrix(data=jnp.asarray(d[None, :]), offsets=(0,))
        r = np.random.default_rng(5).standard_normal(n)
        res = dist_impl_restarted_ca_lanczos(
            A, r, 16, hier, n_wanted=2, s=s, tol=1e-5, max_restarts=30
        )
        assert res.converged
        np.testing.assert_allclose(
            np.sort(np.asarray(res.eigs))[::-1], np.sort(top)[::-1], rtol=1e-3
        )
