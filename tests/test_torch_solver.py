"""The port's host direct solver against the JAX package's.

Both run the same C++ engine, but ``analyze_fastest`` picks the ordering by
timing trial factorizations, so the two factors may differ: the tests
compare solutions and residuals, never factors. Solutions of these
well-conditioned systems agree to rtol 1e-10; residuals are held to 1e-12
(ldlt) and 1e-10 (lu, static pivoting plus refinement)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from hpclinalg_torch.cache import plan_cache

torch.set_num_threads(1)


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.eye(k)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


def unsym(k, seed=0):
    L = laplace2d(k)
    n = L.shape[0]
    P = sp.random(n, n, 0.01, random_state=np.random.default_rng(seed))
    return (L + P).tocsr()


def _rel_res(A, x, b):
    return np.linalg.norm(A @ x - b) / np.linalg.norm(b)


def _both(A, S, b):
    Aj = hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(nshards=S))
    At = ht.DistSparseMatrix.from_scipy(A, ht.backend_auto(S, device="cpu"))
    bj = hl.DistVector.from_global(b, Aj.backend)
    bt = ht.DistVector.from_global(b, At.backend)
    return Aj, At, bj, bt


@pytest.mark.parametrize("S", [1, 4])
def test_ldlt_matches(S):
    A = laplace2d(20)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    Aj, At, bj, bt = _both(A, S, b)
    F = ht.ldlt(At)
    assert F.native is not None, "the C++ engine must load"
    x = F.solve(bt)
    assert isinstance(x, ht.DistVector)
    assert np.array_equal(x.partition, At.row_partition)
    xt = x.to_numpy()
    xj = hl.ldlt(Aj).solve(bj).to_numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-10 * abs(xj).max())
    assert _rel_res(A, xt, b) <= 1e-12
    # host array in, host array out; transpose solve of a symmetric system
    np.testing.assert_allclose(F.solve(b), xt, rtol=1e-12)
    np.testing.assert_allclose(F.solve(b, transpose=True), xt, rtol=1e-10)


@pytest.mark.parametrize("S", [1, 4])
def test_lu_matches(S):
    A = unsym(18)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    Aj, At, bj, bt = _both(A, S, b)
    F = ht.lu(At)
    assert F.native is not None
    xt = F.solve(bt).to_numpy()
    xj = hl.lu(Aj).solve(bj).to_numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-10 * abs(xj).max())
    assert _rel_res(A, xt, b) <= 1e-10
    xT = F.solve(b, transpose=True)
    assert _rel_res(A.T, xT, b) <= 1e-10
    B = np.random.default_rng(3).standard_normal((A.shape[0], 3))
    X = F.solve_matrix(B)
    assert np.linalg.norm(A @ X - B) / np.linalg.norm(B) <= 1e-10


def test_refactorize_same_pattern():
    A = unsym(16, seed=4)
    be = ht.backend_auto(4, device="cpu")
    At = ht.DistSparseMatrix.from_scipy(A, be)
    F = ht.lu(At)
    A2 = A.copy()
    A2.data = A2.data * 1.5 + 0.25
    At2 = At.with_values(ht.DistSparseMatrix.from_scipy(A2, be).nzval)
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    assert F.refactorize(At2) is F
    assert _rel_res(A2, F.solve(b), b) <= 1e-10
    other = ht.DistSparseMatrix.from_scipy(laplace2d(16), be)
    with pytest.raises(ValueError):
        F.refactorize(other)


@pytest.mark.parametrize("S", [1, 4])
def test_backslash_cache_hit(S):
    """Same pattern, new values: the second solve reuses the cached
    factorization object and refactorizes; same values skip even that."""
    ht.clear_plan_cache("backslash")
    A = laplace2d(14)
    b = np.random.default_rng(6).standard_normal(A.shape[0])
    Aj, At, bj, bt = _both(A, S, b)
    x1 = ht.solve(At, bt)
    c = plan_cache("backslash")
    assert len(c) == 1
    F = next(iter(c.values()))
    assert F.kind == "ldlt", "a symmetric matrix takes the LDLt path"
    np.testing.assert_allclose(x1.to_numpy(), hl.solve(Aj, bj).to_numpy(),
                               rtol=1e-10)
    A2 = (A * 3.0 + sp.eye(A.shape[0])).tocsr()
    At2 = At.with_values(ht.DistSparseMatrix.from_scipy(
        A2, At.backend).nzval)
    x2 = ht.solve(At2, bt)
    assert len(c) == 1 and next(iter(c.values())) is F and F.A is At2
    assert _rel_res(A2, x2.to_numpy(), b) <= 1e-12
    vals = F._vals_ref
    ht.solve(At2, bt)
    assert F._vals_ref is vals
    # Symmetric marker and an explicit lu both solve the same system
    x3 = ht.solve(ht.Symmetric(At2), b)
    np.testing.assert_allclose(x3, x2.to_numpy(), rtol=1e-10)
    x4 = ht.solve(At2, b, symmetric=False)
    np.testing.assert_allclose(x4, x2.to_numpy(), rtol=1e-9)
    assert len(c) == 2
    ht.clear_plan_cache("backslash")


def test_ldlt_requires_square():
    be = ht.backend_auto(2, device="cpu")
    with pytest.raises(ValueError):
        ht.ldlt(ht.DistSparseMatrix.from_scipy(
            sp.random(4, 5, 0.5, random_state=1), be))


def test_complex_symmetric_ldlt():
    A = (laplace2d(10) - 0.3 * sp.eye(100) + 0.05j * sp.eye(100)).tocsr()
    b = np.random.default_rng(7).standard_normal(100) + 1j
    be = ht.backend_auto(4, device="cpu")
    F = ht.ldlt(ht.DistSparseMatrix.from_scipy(A, be))
    x = F.solve(b)
    assert x.dtype == np.complex128
    assert _rel_res(A, x, b) <= 1e-12
