"""make_operator routing: every branch lands the right format and the
routed operator multiplies like the original matrix (reference seam:
SpMV.m:1-9 takes arbitrary sparse input; the corpus harness feeds it
SuiteSparse structure)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from ca_lanczos_tpu.ops.formats import (
    OperatorRoute,
    dia_from_scipy,
    make_operator,
)
from ca_lanczos_tpu.ops.spmv import DenseMatrix, DiaMatrix, EllMatrix


def _matvec_parity(A, csr, rtol=1e-5, atol=1e-6, perm=None):
    n = csr.shape[0]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n)
    want = csr @ x
    x_op = x if perm is None else x[perm]
    got = np.asarray(A.matvec(jnp.asarray(x_op, A.dtype)))
    if perm is not None:
        out = np.empty_like(got)
        out[perm] = got
        got = out
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def tridiag(n, lo=-1.0, di=2.0, hi=-1.0):
    o = np.ones(n)
    return sp.diags([lo * o[:-1], di * o, hi * o[:-1]], [-1, 0, 1]).tocsr()


class TestDiaFromScipy:
    def test_planes_match_dense(self):
        n = 300
        a = tridiag(n)
        A = dia_from_scipy(a)
        assert isinstance(A, DiaMatrix)
        np.testing.assert_allclose(np.asarray(A.to_dense()), a.toarray())

    def test_rejects_scatter(self):
        n = 4096
        rng = np.random.default_rng(0)
        rows = np.repeat(np.arange(n), 4)
        cols = rng.integers(0, n, rows.shape)
        a = sp.csr_matrix((np.ones(rows.shape), (rows, cols)), (n, n))
        assert dia_from_scipy(a) is None  # ~16k distinct offsets

    def test_waste_cap(self):
        # 3 diagonals but only the main one populated beyond a few entries
        n = 1024
        a = sp.lil_matrix((n, n))
        a.setdiag(np.ones(n))
        a[0, 5] = 1.0
        a[7, 2] = 1.0
        # offsets {-5, 0, 5}: 3n planes vs nnz = n + 2
        assert dia_from_scipy(a.tocsr(), waste_cap=2.0) is None
        assert dia_from_scipy(a.tocsr(), waste_cap=4.0) is not None


class TestMakeOperator:
    def test_dense_cutoff(self):
        a = tridiag(256)
        A, route = make_operator(a)
        assert isinstance(A, DenseMatrix) and route.format == "dense"
        _matvec_parity(A, a)

    def test_banded_to_dia(self):
        a = tridiag(5000)
        A, route = make_operator(a)
        assert isinstance(A, DiaMatrix) and route.format == "dia"
        assert route.perm is None
        _matvec_parity(A, a)

    def test_scattered_band_to_ell(self):
        # 8 nnz/row scattered in a wide band: too many distinct offsets
        # for DIA even after RCM, so the route lands on ELL
        n = 8192
        rng = np.random.default_rng(1)
        rows = np.repeat(np.arange(n), 8)
        cols = np.clip(rows + rng.integers(-512, 512, rows.shape), 0, n - 1)
        a = sp.csr_matrix(
            (rng.standard_normal(rows.shape), (rows, cols)), (n, n)
        )
        a.sum_duplicates()
        A, route = make_operator(a)
        assert isinstance(A, EllMatrix) and route.format == "ell"
        _matvec_parity(A, a, perm=route.perm, rtol=1e-10, atol=1e-10)

    def test_hidden_band_reordered(self):
        # randomly permuted banded matrix: scattered as given, banded
        # under RCM — the route must reorder and still multiply right
        n = 6144
        band = tridiag(n) + sp.diags(
            [np.ones(n - 3), np.ones(n - 3)], [-3, 3]
        )
        rng = np.random.default_rng(2)
        p = rng.permutation(n)
        scat = sp.csr_matrix(band.tocsr()[p][:, p])
        A, route = make_operator(scat)
        assert route.perm is not None
        assert route.format == "dia"
        assert route.bandwidth_after < route.bandwidth_before
        _matvec_parity(A, scat, perm=route.perm)

    def test_apply_restore_roundtrip(self):
        route = OperatorRoute(
            "dia", np.asarray([2, 0, 1, 3]), [], 4
        )
        v = np.arange(8.0).reshape(4, 2)
        np.testing.assert_array_equal(route.restore(route.apply(v)), v)
        ident = OperatorRoute("dia", None, [], 4)
        np.testing.assert_array_equal(ident.apply(v), v)
        np.testing.assert_array_equal(ident.restore(v), v)

    def test_ell_fallback_and_disable(self):
        # uniform random scatter: RCM cannot band it -> ELL fallback
        n = 4096
        rng = np.random.default_rng(4)
        rows = np.repeat(np.arange(n), 3)
        cols = rng.integers(0, n, rows.shape)
        a = sp.csr_matrix((np.ones(rows.shape), (rows, cols)), (n, n))
        a = (a + a.T).tocsr()  # symmetric so RCM is meaningful
        a.sum_duplicates()
        A, route = make_operator(a)
        assert isinstance(A, EllMatrix) and route.format == "ell"
        assert any("fallback" in s for s in route.notes)
        _matvec_parity(A, a, perm=route.perm)
        with pytest.raises(ValueError):
            make_operator(a, allow_ell_fallback=False)

    def test_prefer_forced(self):
        a = tridiag(3000)
        A, route = make_operator(a, prefer="ell")
        assert isinstance(A, EllMatrix)
        _matvec_parity(A, a)
        A, route = make_operator(a, prefer="dense")
        assert isinstance(A, DenseMatrix)
        with pytest.raises(ValueError):
            make_operator(a, prefer="nope")

    def test_eigensolve_through_route(self):
        # end to end: routed operator (reordered branch) feeds the CA
        # driver; Ritz values match the original matrix's spectrum
        n = 3072
        d = np.linspace(1.0, 2.0, n)
        d[-1] = 3.0
        band = sp.diags([d, 0.01 * np.ones(n - 1), 0.01 * np.ones(n - 1)],
                        [0, -1, 1]).tocsr()
        rng = np.random.default_rng(5)
        p = rng.permutation(n)
        scat = sp.csr_matrix(band[p][:, p])
        A, route = make_operator(scat)
        assert route.perm is not None
        from ca_lanczos_tpu.config import Basis, Orth
        from ca_lanczos_tpu.solvers.ca_lanczos import ca_lanczos

        r0 = route.apply(rng.standard_normal(n))
        res = ca_lanczos(
            A, jnp.asarray(r0, A.dtype), 4, 24,
            basis=Basis.MONOMIAL, orth=Orth.FULL,
        )
        T = np.asarray(res.T)
        top = np.max(np.linalg.eigvalsh((T + T.T) / 2))
        from scipy.sparse.linalg import eigsh

        oracle = eigsh(band, k=1, which="LA", return_eigenvectors=False)[0]
        assert abs(top - oracle) < 1e-8

    def test_solve_auto_raw_scipy(self):
        # the one-call production path: raw scattered scipy matrix in,
        # eigenpairs in ORIGINAL ordering out (Q_conv decoded through
        # the route's permutation)
        n = 3072
        d = np.linspace(1.0, 2.0, n)
        d[-3:] = [3.0, 3.5, 4.0]
        band = sp.diags([d, 0.01 * np.ones(n - 1), 0.01 * np.ones(n - 1)],
                        [0, -1, 1]).tocsr()
        rng = np.random.default_rng(6)
        p = rng.permutation(n)
        scat = sp.csr_matrix(band[p][:, p])

        from ca_lanczos_tpu.config import LanczosConfig
        from ca_lanczos_tpu.harness.auto import solve_auto

        res = solve_auto(
            scat, rng.standard_normal(n), 48,
            LanczosConfig(n_wanted=3),
        )
        assert res.converged and res.route is not None
        assert res.route.perm is not None
        # residuals in the ORIGINAL (scat) ordering: each decoded Ritz
        # vector must be an eigenvector of the ORIGINAL matrix (Rayleigh
        # quotient residual — robust to column/eig ordering)
        Q = np.asarray(res.Q_conv)
        for j in range(Q.shape[1]):
            q = Q[:, j] / np.linalg.norm(Q[:, j])
            lam = q @ (scat @ q)
            r = scat @ q - lam * q
            assert np.linalg.norm(r) < 1e-6, (j, lam)
        assert np.max(np.asarray(res.eigs)) > 3.9  # found the 4.0 pair


class TestOperatorSerialization:
    def test_roundtrip_all_formats(self, tmp_path):
        from ca_lanczos_tpu.ops.formats import load_operator_npz, save_operator

        rng = np.random.default_rng(8)
        n = 2048
        x = rng.standard_normal(n)

        # one matrix per format via forced routes
        band = tridiag(n)
        scattered = sp.csr_matrix(
            (rng.standard_normal(4 * n),
             (np.repeat(np.arange(n), 4),
              np.clip(np.repeat(np.arange(n), 4)
                      + rng.integers(-300, 300, 4 * n), 0, n - 1))),
            (n, n))
        scattered.sum_duplicates()
        cases = [
            make_operator(band, prefer="dia"),
            make_operator(band, prefer="ell"),
            make_operator(band, prefer="dense"),
            make_operator(scattered, prefer="ell"),
        ]
        # and one ROUTED case with a permutation
        p = rng.permutation(n)
        scat = sp.csr_matrix(band[p][:, p])
        cases.append(make_operator(scat))

        for i, (A, route) in enumerate(cases):
            path = str(tmp_path / f"op{i}.npz")
            save_operator(path, A, route)
            B, route2 = load_operator_npz(path)
            assert type(B) is type(A)
            ya = np.asarray(A.matvec(jnp.asarray(x, A.dtype)))
            yb = np.asarray(B.matvec(jnp.asarray(x, B.dtype)))
            np.testing.assert_array_equal(ya, yb)  # bit-exact round-trip
            assert (route2.format == route.format
                    and route2.nnz == route.nnz)
            if route.perm is None:
                assert route2.perm is None
            else:
                np.testing.assert_array_equal(route2.perm, route.perm)


class TestNegateOperator:
    @pytest.mark.parametrize("prefer", ["dia", "ell", "dense"])
    def test_negates_every_format(self, prefer):
        """negate_operator keeps the format and negates the product."""
        from ca_lanczos_tpu.ops.formats import negate_operator

        a = tridiag(1024, lo=-0.5, di=3.0, hi=-1.5)
        A, _ = make_operator(a, prefer=prefer)
        An = negate_operator(A)
        assert type(An) is type(A)
        x = np.random.default_rng(0).standard_normal(1024)
        np.testing.assert_allclose(
            np.asarray(An.matvec(jnp.asarray(x, An.dtype))), -(a @ x),
            rtol=1e-12, atol=1e-12,
        )

    def test_dia_host_planes_option(self):
        from ca_lanczos_tpu.ops.formats import dia_from_scipy

        A = dia_from_scipy(tridiag(512), device=False)
        assert isinstance(np.asarray(A.data), np.ndarray)
        assert type(A.data) is np.ndarray  # stayed host-side


class TestRouteDtype:
    @pytest.mark.parametrize("prefer", ["auto", "dia", "ell", "dense"])
    def test_float32_storage_of_float64_matrix(self, prefer):
        """dtype=float32 stores an f64 matrix's values in f32 on every
        route (the two-stage pipeline's solve copy)."""
        a = tridiag(3000 if prefer != "dense" else 256)
        A, route = make_operator(a, prefer=prefer, dtype=np.float32)
        assert A.dtype == jnp.float32
        _matvec_parity(A, a, perm=route.perm, rtol=1e-6, atol=1e-6)

    def test_default_keeps_float64(self):
        A, _ = make_operator(tridiag(3000))
        assert A.dtype == jnp.float64
