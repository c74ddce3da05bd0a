"""Right division, the transposed solve and the LazyTranspose attributes of
the port against the JAX package's.

These were missing from the port: ``vᵀ / A`` and ``vᵀ / Aᵀ`` raised,
``solve(A.T, b)`` failed, and the port's LazyTranspose had no ``dtype``,
``backend``, ``__radd__``/``__rsub__`` or ``to_numpy``. The scenario of
tests/test_factorization.py::test_right_division runs through both
packages at S = 1, 2 and 4; the solutions agree to rtol 1e-10 (the two
packages factor with orderings chosen by timing, so their last digits may
differ).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht

torch.set_num_threads(1)

SHARDS = [1, 2, 4]
RTOL = 1e-10


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    return (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k))).tocsr()


def scenario(S):
    """test_right_division's matrix and vector, in both packages."""
    rng = np.random.default_rng(104)
    A = (laplace2d(5) + sp.random(25, 25, 0.08, random_state=rng)).tocsr()
    v = np.random.default_rng(2).standard_normal(25)
    bj, bt = hl.backend_auto(nshards=S), ht.backend_auto(S, device="cpu")
    return (A, v, hl.DistSparseMatrix.from_scipy(A, bj),
            ht.DistSparseMatrix.from_scipy(A, bt),
            hl.DistVector.from_global(v, bj), ht.DistVector.from_global(v, bt))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("S", SHARDS)
def test_right_division(S):
    """vᵀ / A = (Aᵀ \\ v)ᵀ and vᵀ / Aᵀ = (A \\ v)ᵀ (ref:
    HPCLinearAlgebra.jl:713-744)."""
    A, v, Aj, At, vj, vt = scenario(S)
    yt = vt.T / At
    assert isinstance(yt, ht.LazyTranspose) and yt.shape == (1, 25)
    y = yt.T.to_numpy()
    assert np.linalg.norm(A.T @ y - v) / np.linalg.norm(v) < 1e-10
    _close(y, (vj.T / Aj).T.to_numpy())
    zt = vt.T / At.T
    z = zt.T.to_numpy()
    assert np.linalg.norm(A @ z - v) / np.linalg.norm(v) < 1e-10
    _close(z, (vj.T / Aj.T).T.to_numpy())


@pytest.mark.parametrize("S", SHARDS)
def test_solve_lazy_transpose(S):
    """solve(A.T, b) solves Aᵀx = b through the backslash cache, like
    solve(A, b, transpose=True) and the JAX package's solve(A.T, b)."""
    A, v, Aj, At, vj, vt = scenario(S)
    ht.clear_plan_cache("backslash")
    x = ht.solve(At.T, vt)
    assert isinstance(x, ht.DistVector)
    np.testing.assert_array_equal(x.partition, At.row_partition)
    _close(x.to_numpy(), hl.solve(Aj.T, vj).to_numpy())
    assert np.linalg.norm(A.T @ x.to_numpy() - v) / np.linalg.norm(v) < 1e-10
    _close(ht.solve(At, vt, transpose=True).to_numpy(), x.to_numpy())
    _close(ht.solve(At.T, vt, transpose=True).to_numpy(),
           ht.solve(At, vt).to_numpy())
    # one factorization serves both directions
    assert len(ht.BackslashCache._cache()) == 1


@pytest.mark.parametrize("S", SHARDS)
def test_lazy_transpose_attributes(S):
    """dtype, backend, to_numpy, and o + Aᵀ / o - Aᵀ when o's own operator
    punts (a dense o and a lazy dense transpose)."""
    A, v, Aj, At, vj, vt = scenario(S)
    bt = ht.backend_auto(S, device="cpu")
    assert At.T.dtype == At.dtype == torch.float64
    assert At.T.backend == bt
    for Lt, Lj in ((At.T, Aj.T), (vt.T, vj.T)):
        got, want = Lt.to_numpy(), Lj.to_numpy()
        got = got.toarray() if sp.issparse(got) else got
        want = want.toarray() if sp.issparse(want) else want
        assert got.shape == want.shape == Lt.shape
        _close(got, want)
    M = np.random.default_rng(3).standard_normal((6, 9))
    N = np.random.default_rng(4).standard_normal((9, 6))
    Mt = ht.DistDenseMatrix.from_global(M, bt)
    Nt = ht.DistDenseMatrix.from_global(N, bt)
    Mj = hl.DistDenseMatrix.from_global(M, hl.backend_auto(nshards=S))
    _close(Mt.T.to_numpy(), Mj.T.to_numpy())
    _close((Mt + Nt.T).to_numpy(), M + N.T)
    _close((Mt - Nt.T).to_numpy(), M - N.T)
    _close((Nt.T + Mt).to_numpy(), N.T + M)
    _close((Nt.T - Mt).to_numpy(), N.T - M)
