"""BSR operator tests: SpMV parity, padding, use inside the solvers."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from ca_lanczos_tpu.config import Basis, Orth
from ca_lanczos_tpu.ops.bsr import BsrMatrix
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_monomial
from ca_lanczos_tpu.solvers.ca_lanczos import ca_lanczos


def _block_laplacian(n_blocks=16, bs=4, seed=0):
    """SPD block-tridiagonal matrix with dense (bs, bs) blocks."""
    rng = np.random.default_rng(seed)
    n = n_blocks * bs
    blocks = {}
    for i in range(n_blocks):
        B = rng.standard_normal((bs, bs)) * 0.1
        blocks[(i, i)] = B @ B.T + 4 * np.eye(bs)
        if i + 1 < n_blocks:
            C = rng.standard_normal((bs, bs)) * 0.2
            blocks[(i, i + 1)] = C
            blocks[(i + 1, i)] = C.T
    dense = np.zeros((n, n))
    for (i, j), B in blocks.items():
        dense[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = B
    return dense


class TestBsr:
    def test_spmv_parity(self):
        dense = _block_laplacian()
        A = BsrMatrix.from_dense(dense, block_size=4)
        n = dense.shape[0]
        x = np.random.default_rng(1).standard_normal(n)
        y = np.asarray(A.matvec(jnp.asarray(x)))
        np.testing.assert_allclose(y, dense @ x, atol=1e-12)
        np.testing.assert_allclose(np.asarray(A.to_dense()), dense, atol=1e-15)

    def test_multivector(self):
        dense = _block_laplacian()
        A = BsrMatrix.from_dense(dense, block_size=4)
        X = np.random.default_rng(2).standard_normal((dense.shape[0], 5))
        Y = np.asarray(A.matvec(jnp.asarray(X)))
        np.testing.assert_allclose(Y, dense @ X, atol=1e-12)

    def test_padding_unaligned_n(self):
        dense = _block_laplacian(n_blocks=7, bs=3)[:20, :20]  # n=20, block 8
        A = BsrMatrix.from_dense(dense, block_size=8)
        assert A.n == 24  # padded to multiple of 8
        x = np.random.default_rng(3).standard_normal(20)
        xp = np.zeros(24)
        xp[:20] = x
        y = np.asarray(A.matvec(jnp.asarray(xp)))[:20]
        np.testing.assert_allclose(y, dense @ x, atol=1e-12)

    def test_in_ca_lanczos(self):
        dense = _block_laplacian(n_blocks=32, bs=4)
        A = BsrMatrix.from_dense(dense, block_size=4)
        n = dense.shape[0]
        r = jnp.ones((n,), jnp.float64)
        res = ca_lanczos(A, r, s=4, total_steps=40, basis=Basis.MONOMIAL, orth=Orth.FULL)
        d = np.sort(np.linalg.eigvalsh(res.T))[::-1]
        exact = np.sort(np.linalg.eigvalsh(dense))[::-1]
        # Top Ritz value converges to the top eigenvalue.
        np.testing.assert_allclose(d[0], exact[0], rtol=1e-8)

    def test_matrix_powers(self):
        dense = _block_laplacian()
        A = BsrMatrix.from_dense(dense, block_size=4)
        n = dense.shape[0]
        q = jnp.asarray(np.random.default_rng(4).standard_normal(n))
        V = np.asarray(matrix_powers_monomial(A, q, 3))
        ref = np.stack(
            [np.asarray(q)]
            + [np.linalg.matrix_power(dense, k) @ np.asarray(q) for k in (1, 2, 3)],
            axis=1,
        )
        np.testing.assert_allclose(V, ref, rtol=1e-10, atol=1e-10)


class TestDistBsr:
    """Distributed BSR (parallel/dist_bsr.py, round-4 VERDICT item 6):
    block-row sharding with s-deep block halos; every dist driver rides
    it through the RowStateMixin contract."""

    def _mesh(self):
        from ca_lanczos_tpu.parallel import make_mesh

        return make_mesh(8)

    def test_dist_matrix_powers_parity(self):
        from ca_lanczos_tpu.parallel import DistBsr, dist_bsr_matrix_powers

        mesh = self._mesh()
        dense = _block_laplacian(n_blocks=192, bs=4, seed=2)
        n = dense.shape[0]
        A = BsrMatrix.from_dense(dense, block_size=4)
        Ad = DistBsr.from_bsr(A, mesh, s_max=4)
        rng = np.random.default_rng(3)
        x = rng.standard_normal(n)
        xd = Ad.shard_vector(x, mesh)
        z = jnp.zeros(4)
        V = np.asarray(dist_bsr_matrix_powers(Ad, xd, 4, z, z, mesh))[:n]
        ref = x.copy()
        np.testing.assert_allclose(V[:, 0], x)
        for k in range(1, 5):
            ref = dense @ ref
            np.testing.assert_allclose(V[:, k], ref, rtol=1e-10, atol=1e-10)

    def test_dist_ca_lanczos_parity(self):
        from ca_lanczos_tpu.parallel.driver import dist_ca_lanczos
        from ca_lanczos_tpu.solvers.ca_lanczos import ca_lanczos

        mesh = self._mesh()
        dense = _block_laplacian(n_blocks=256, bs=4, seed=4)
        n = dense.shape[0]
        A = BsrMatrix.from_dense(dense, block_size=4)
        rng = np.random.default_rng(5)
        r = rng.standard_normal(n)
        res = dist_ca_lanczos(A, r, 4, 12, mesh)
        host = ca_lanczos(A, jnp.asarray(r), 4, 12)
        np.testing.assert_allclose(
            np.linalg.eigvalsh(res.T), np.linalg.eigvalsh(np.asarray(host.T)),
            rtol=1e-8, atol=1e-8,
        )

    def test_dist_restarted_converges(self):
        """Planted top pairs on a block operator through the flagship
        restarted driver (the BASELINE configs[4] driver class)."""
        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.parallel.restarted import dist_restarted_ca_lanczos

        mesh = self._mesh()
        nb, bs = 512, 4
        n = nb * bs
        rng = np.random.default_rng(6)
        dense_diag = np.linspace(1.0, 50.0, n)
        top = np.array([80.0, 85.0, 90.0])
        dense_diag[-3:] = top
        # block-tridiagonal coupling around the planted diagonal
        A = BsrMatrix.from_scipy(
            __import__("scipy.sparse", fromlist=["sparse"]).diags(
                [np.full(n - 1, 1e-2), dense_diag, np.full(n - 1, 1e-2)],
                [-1, 0, 1],
            ).tocsr(),
            block_size=bs,
        )
        cfg = LanczosConfig(s=4, n_wanted=3, tol=1e-7, max_restarts=30)
        res = dist_restarted_ca_lanczos(A, rng.standard_normal(n), 16, mesh, cfg)
        assert res.converged
        np.testing.assert_allclose(
            np.sort(np.asarray(res.eigs))[::-1], np.sort(top)[::-1], rtol=1e-6
        )

    @pytest.mark.slow
    def test_dist_million_row_block_operator(self):
        """>=1M-row block operator through the dist CA driver on the
        8-way virtual mesh (VERDICT item 6 'Done' condition)."""
        from ca_lanczos_tpu.parallel.driver import dist_ca_lanczos

        nb, bs = 131072, 8  # 1,048,576 rows
        n = nb * bs
        rng = np.random.default_rng(7)
        import scipy.sparse as sp

        d = np.linspace(1.0, 4.0, n)
        a = sp.diags([np.full(n - 1, 0.05), d, np.full(n - 1, 0.05)],
                     [-1, 0, 1]).tocsr().astype(np.float32)
        A = BsrMatrix.from_scipy(a, block_size=bs)
        r = rng.standard_normal(n).astype(np.float32)
        mesh = self._mesh()
        res = dist_ca_lanczos(A, r, 4, 8, mesh)
        evs = np.linalg.eigvalsh(res.T)
        assert np.isfinite(res.T).all()
        # Ritz values live inside the spectrum bounds
        assert evs.max() <= 4.2 and evs.min() >= 0.8

    def test_partition_routes_to_dist_bsr(self):
        from ca_lanczos_tpu.parallel import DistBsr
        from ca_lanczos_tpu.parallel.step import partition_operator

        mesh = self._mesh()
        dense = _block_laplacian(n_blocks=64, bs=4)
        A = BsrMatrix.from_dense(dense, block_size=4)
        Ad = partition_operator(A, mesh, s_max=4)
        assert isinstance(Ad, DistBsr)
        assert partition_operator(Ad, mesh, s_max=4) is Ad


class TestBsrToDia:
    """Block-banded BSR converts to a scalar DIA whose powers need no
    gather (ops/bsr.py to_dia)."""

    def test_conversion_exact(self):
        rng = np.random.default_rng(0)
        nb, bs = 24, 8
        n = nb * bs
        import scipy.sparse as sp

        rows, cols, vals = [], [], []
        for i in range(nb):
            for d in (-1, 0, 1):
                j = i + d
                if 0 <= j < nb:
                    T = rng.standard_normal((bs, bs))
                    for b in range(bs):
                        for c in range(bs):
                            rows.append(i * bs + b)
                            cols.append(j * bs + c)
                            vals.append(T[b, c])
        a = sp.csr_matrix((vals, (rows, cols)), (n, n))
        A = BsrMatrix.from_scipy(a, block_size=bs)
        D = A.to_dia()
        assert len(D.offsets) == 31  # 2*bs*bw - 1 for block tridiag
        np.testing.assert_allclose(np.asarray(D.to_dense()), a.toarray(),
                                   atol=1e-14)

    def test_unstructured_raises(self):
        rng = np.random.default_rng(1)
        nb, bs = 64, 8
        n = nb * bs
        import scipy.sparse as sp

        # scattered block columns: too many distinct block offsets
        rows, cols, vals = [], [], []
        for i in range(nb):
            for j in rng.choice(nb, 3, replace=False):
                rows.append(i * bs)
                cols.append(int(j) * bs)
                vals.append(1.0)
        a = sp.csr_matrix((vals, (rows, cols)), (n, n))
        A = BsrMatrix.from_scipy(a, block_size=bs)
        with pytest.raises(ValueError, match="not band-convertible"):
            A.to_dia(max_offsets=48)
