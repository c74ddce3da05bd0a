"""The input generators against hand counts and independent constructions,
and the harness's shard layouts against the program's own."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pbcore import grids
from reference import hpcg, poisson


def nnz(dims) -> int:
    """Stored entries of the 27-point operator: a product over the axes,
    an axis of length k contributing 3k - 2 neighbour pairs."""
    return int(np.prod([3 * int(k) - 2 for k in dims]))


@pytest.mark.parametrize("dims", [(8, 8, 8), (5, 6, 7), (8, 8, 32)])
def test_hpcg27_builder(dims):
    A = grids.hpcg27(dims)
    n = int(np.prod(dims))
    assert A.shape == (n, n) and A.has_sorted_indices
    assert A.nnz == nnz(dims)
    rowlen = np.diff(A.indptr)
    # HPCG's b = A 1: 26 less one for each neighbour
    np.testing.assert_array_equal(A @ np.ones(n), 26 - (rowlen - 1))
    assert (A != A.T).nnz == 0
    np.testing.assert_array_equal(A.diagonal(), 26.0)
    # against the kron of three tridiagonal all-ones patterns
    T = [sp.diags([1, 1, 1], [-1, 0, 1], shape=(k, k)) for k in dims]
    B = 27 * sp.eye(n) - sp.kron(sp.kron(T[2], T[1]), T[0])
    assert abs(A - B).max() == 0
    x = np.random.default_rng(0).standard_normal(n)
    np.testing.assert_allclose(
        hpcg.stencil27(torch.from_numpy(x), dims).numpy(), A @ x,
        rtol=0, atol=1e-12)


def test_hpcg_104_sizes():
    """The configurations' stated sizes: 310^3 and 310^2 * 1246 entries."""
    assert nnz((104, 104, 104)) == 29_791_000 == 310 ** 3
    assert nnz((104, 104, 416)) == 119_740_600 == 310 ** 2 * 1246


def test_poisson_values_and_operator():
    k = 12
    gen = torch.Generator().manual_seed(5)
    ch, cv = grids.conductivities(3, k, 0.5, 1.5, gen, "cpu")
    assert float(ch.min()) >= 0.5 and float(cv.max()) <= 1.5
    L = grids.laplace2d(k)
    L.sort_indices()
    V = grids.poisson_values(ch, cv)
    assert V.shape == (3, L.nnz)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(k * k))
    for p in range(3):
        M = sp.csr_matrix((V[p].numpy(), L.indices, L.indptr), shape=L.shape)
        assert abs(M - M.T).max() == 0
        assert np.linalg.eigvalsh(M.toarray()).min() > 0
        np.testing.assert_allclose(poisson.apply(ch[p], cv[p], x).numpy(),
                                   M @ x.numpy(), rtol=0, atol=1e-13)
    ones = grids.poisson_values(torch.ones(1, k, k + 1, dtype=torch.float64),
                                torch.ones(1, k + 1, k, dtype=torch.float64))
    np.testing.assert_array_equal(ones[0].numpy(), L.data)


def test_layouts_match_the_program():
    import hpclinalg_torch as ht

    A = grids.hpcg27((6, 5, 7))
    be = ht.backend_auto(4, device="cpu")
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    n = A.shape[0]
    v = torch.from_numpy(np.random.default_rng(2).standard_normal((2, n)))
    x = ht.DistVector.from_global(v[1].numpy(), be)
    got = grids.local_rows(v, Ad.row_partition, x.data.shape[1], be.shards)
    assert torch.equal(got[1], x.data)
    vals = torch.from_numpy(np.random.default_rng(3).standard_normal(A.nnz))
    B = sp.csr_matrix((vals.numpy(), A.indices, A.indptr), shape=A.shape)
    Bd = ht.DistSparseMatrix.from_scipy(B, be)
    nz = grids.local_values(vals, A.indptr, Ad.row_partition,
                            Ad.structure.NNZpad, be.shards)
    assert torch.equal(nz, Bd.nzval)
