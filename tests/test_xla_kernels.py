"""The plain-XLA kernels every solve runs, against float64 oracles.

Matrix powers (the monomial and Newton scans of ops.matrix_powers) on DIA
and ELL operators over operator shape, s and basis; the ELL gather on
general sparsity patterns; and the operator-format routing that decides
which of the two a matrix gets (reference seams: SpMV.m:1-9,
matrix_powers_monomial.m:6-12, matrix_powers_newton.m:25-29).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from ca_lanczos_tpu.basis.newton import newton_basis_matrix
from ca_lanczos_tpu.config import Basis
from ca_lanczos_tpu.ops.formats import make_operator
from ca_lanczos_tpu.ops.matrix_powers import matrix_powers
from ca_lanczos_tpu.ops.spmv import DiaMatrix, EllMatrix
from ca_lanczos_tpu.solvers.ca_lanczos import monomial_basis_matrix


def _banded(n, offsets, seed):
    """Random symmetric-free banded matrix on ``offsets`` (f64 CSR),
    scaled to spectral radius < 1 so s-step powers stay O(1)."""
    rng = np.random.default_rng(seed)
    diags = [0.1 * rng.standard_normal(n - abs(o)) for o in offsets]
    a = sp.diags(diags, offsets, shape=(n, n)).tocsr()
    return a + 0.5 * sp.eye(n, format="csr")


def _pattern(name, n, seed):
    """General sparsity patterns the DIA format rejects."""
    rng = np.random.default_rng(seed)
    if name == "lap27":
        g = round(n ** (1 / 3))
        d1 = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], (g, g))
        return (sp.kron(sp.kron(d1, d1), d1) / 27.0).tocsr()
    if name == "randband":
        rows = np.repeat(np.arange(n), 5)
        cols = np.clip(rows + rng.integers(-40, 41, rows.shape), 0, n - 1)
    elif name == "ring":
        rows = np.repeat(np.arange(n), 4)
        cols = (rows + rng.integers(-300, 301, rows.shape)) % n
    else:  # scattered
        rows = np.repeat(np.arange(n), 3)
        cols = rng.integers(0, n, rows.shape)
    a = sp.csr_matrix((rng.standard_normal(rows.shape), (rows, cols)), (n, n))
    a = a + a.T
    a.sum_duplicates()
    scale = np.abs(a).sum(axis=1).max()
    return (a / (1.5 * scale)).tocsr()


def _basis(basis, s, seed):
    if basis == "monomial":
        return Basis.MONOMIAL, monomial_basis_matrix(s)
    shifts = np.random.default_rng(seed).uniform(-0.4, 0.4, s)
    return Basis.NEWTON, newton_basis_matrix(shifts, s)


def _oracle(a, q, B):
    """float64 recurrence V[:,k+1] = A V[:,k] - B[k,k] V[:,k] - B[k-1,k]
    V[:,k-1] with the dense matrix."""
    Ad = a.toarray()
    s = B.shape[1]
    V = np.zeros((len(q), s + 1))
    V[:, 0] = q
    for k in range(s):
        V[:, k + 1] = Ad @ V[:, k] - B[k, k] * V[:, k]
        if k > 0:
            V[:, k + 1] -= B[k - 1, k] * V[:, k - 1]
    return V


OFFSETS = [(-1, 0, 1), (-4, -2, 0, 2, 4), tuple(range(-4, 5)), (-16, 0, 16)]


class TestDiaScanVsDenseOracle:
    @pytest.mark.parametrize("basis", ["monomial", "newton"])
    @pytest.mark.parametrize("s", [1, 2, 4, 8])
    @pytest.mark.parametrize("offsets", OFFSETS, ids=lambda o: f"w{max(o)}d{len(o)}")
    def test_f64_matches(self, offsets, s, basis):
        n = 200
        a = _banded(n, offsets, seed=s)
        A, route = make_operator(a, prefer="dia")
        assert isinstance(A, DiaMatrix) and route.format == "dia"
        b, B = _basis(basis, s, seed=len(offsets))
        q = np.random.default_rng(0).standard_normal(n)
        V = np.asarray(matrix_powers(A, jnp.asarray(q), s, B, b))
        np.testing.assert_allclose(V, _oracle(a, q, B), rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("basis", ["monomial", "newton"])
    @pytest.mark.parametrize("offsets", OFFSETS, ids=lambda o: f"w{max(o)}d{len(o)}")
    def test_f32_storage(self, offsets, basis):
        """f32 planes and vectors stay f32 and agree to f32 roundoff."""
        n, s = 300, 8
        a = _banded(n, offsets, seed=3)
        A, _ = make_operator(a, prefer="dia", dtype=np.float32)
        b, B = _basis(basis, s, seed=5)
        q = np.random.default_rng(1).standard_normal(n)
        V = matrix_powers(A, jnp.asarray(q, jnp.float32), s, B, b)
        assert V.dtype == jnp.float32
        W = _oracle(a.astype(np.float32).astype(np.float64), q, B)
        err = np.linalg.norm(np.asarray(V, np.float64) - W, axis=0)
        assert np.all(err <= 1e-5 * np.linalg.norm(W, axis=0))


class TestEllGatherVsDenseOracle:
    @pytest.mark.parametrize("basis", ["monomial", "newton"])
    @pytest.mark.parametrize("s", [2, 4])
    @pytest.mark.parametrize("name", ["lap27", "randband", "ring", "scattered"])
    def test_f64_matches(self, name, s, basis):
        a = _pattern(name, 512, seed=s)
        A = EllMatrix.from_scipy(a)
        b, B = _basis(basis, s, seed=7)
        q = np.random.default_rng(2).standard_normal(a.shape[0])
        V = np.asarray(matrix_powers(A, jnp.asarray(q), s, B, b))
        np.testing.assert_allclose(V, _oracle(a, q, B), rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("name", ["lap27", "randband", "ring", "scattered"])
    def test_multivector_matvec(self, name):
        a = _pattern(name, 512, seed=1)
        A = EllMatrix.from_scipy(a)
        X = np.random.default_rng(3).standard_normal((a.shape[0], 3))
        np.testing.assert_allclose(np.asarray(A.matvec(jnp.asarray(X))),
                                   a @ X, rtol=1e-12, atol=1e-12)


class TestRouting:
    @pytest.mark.parametrize("name", ["randband", "ring", "scattered"])
    def test_general_sparsity_routes_to_ell(self, name):
        a = _pattern(name, 4096, seed=0)
        A, route = make_operator(a)
        assert isinstance(A, EllMatrix) and route.format == "ell"
        x = np.random.default_rng(4).standard_normal(a.shape[0])
        y = np.asarray(A.matvec(jnp.asarray(route.apply(x))))
        np.testing.assert_allclose(route.restore(y), a @ x, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("offsets", OFFSETS, ids=lambda o: f"w{max(o)}d{len(o)}")
    def test_banded_routes_to_dia(self, offsets):
        a = _banded(4096, offsets, seed=1)
        A, route = make_operator(a)
        assert isinstance(A, DiaMatrix) and route.format == "dia"
        assert route.perm is None and A.offsets == offsets

    def test_rcm_encode_decode_of_eigenvectors(self):
        """A hidden band routes through RCM to DIA; eigenvectors of the
        permuted operator decode to eigenvectors of the original."""
        n = 3000
        band = _banded(n, (-2, -1, 0, 1, 2), seed=2)
        band = (band + band.T) / 2
        p = np.random.default_rng(3).permutation(n)
        scat = sp.csr_matrix(band[p][:, p])
        A, route = make_operator(scat)
        assert route.format == "dia" and route.perm is not None
        Ap = np.asarray(A.to_dense())
        w, V = np.linalg.eigh(Ap)
        X = route.restore(V[:, -3:])
        np.testing.assert_allclose(scat @ X, X * w[-3:], atol=1e-10)
        np.testing.assert_array_equal(route.apply(route.restore(V)), V)
