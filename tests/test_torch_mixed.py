"""The port's sparse × dense products, dense × sparse products, the lazy
dense rules and the solve with a dense right-hand side against the JAX
package's and scipy.

The same scipy and numpy inputs, made from a seed, go through both
packages at S = 1, 2 and 4 shards in f64. The SpMM engine each plan
chooses is the JAX package's; the ELL engine is forced by lowering the
densify cap in both packages, the segment engine by switching the ELL
layout off in both. Products must equal the JAX package's stacked data,
partitions and hash, within rtol 1e-12 of the largest |value|, and scipy's.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg.ops.mixed as jmixed
import hpclinalg.ops.spmv as jspmv
import hpclinalg_torch as ht
import hpclinalg_torch.ops.mixed as tmixed
import hpclinalg_torch.ops.spmv as tspmv

torch.set_num_threads(1)

SHARDS = [1, 2, 4]
RTOL = 1e-12


def backends(S):
    return hl.backend_auto(nshards=S), ht.backend_auto(S, device="cpu")


def sparse_both(A, S):
    bj, bt = backends(S)
    return (hl.DistSparseMatrix.from_scipy(A, bj),
            ht.DistSparseMatrix.from_scipy(A, bt))


def dense_both(M, S, row_partition=None):
    bj, bt = backends(S)
    p = None if row_partition is None else np.asarray(row_partition)
    return (hl.DistDenseMatrix.from_global(M, bj, row_partition=p),
            ht.DistDenseMatrix.from_global(M, bt, row_partition=p))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(1.0, float(np.abs(want).max(
                                   initial=0.0))))


def _same(Ct, Cj, ref):
    assert isinstance(Ct, ht.DistDenseMatrix)
    np.testing.assert_array_equal(Ct.row_partition, Cj.row_partition)
    np.testing.assert_array_equal(Ct.col_partition, Cj.col_partition)
    assert Ct.hash == Cj.hash
    _close(Ct.data.numpy(), np.asarray(Cj.data))
    _close(Ct.to_numpy(), ref)


def _engine(plan):
    if plan.offsets is not None:
        return "dia"
    if plan.densify:
        return "densify"
    return "ell" if plan.ell else "segment"


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    return (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k))).tocsr()


def with_long_rows(n, m, seed):
    """n x m random, 4 % dense, with two long rows that spill past the ELL
    width into the COO tail, and its columns confined to [m/4, 7m/8) so
    the compressed column space is not the identity."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, m, 0.04, format="lil", random_state=rng)
    A[3, :] = rng.standard_normal(m)
    A[n - 2, ::2] = rng.standard_normal((m + 1) // 2)
    A = A.tocsr()
    keep = np.zeros(m, bool)
    keep[m // 4: 7 * m // 8] = True
    return (A @ sp.diags(keep.astype(float))).tocsr()


@pytest.fixture
def engine(request, monkeypatch):
    """Force an SpMM engine in both packages (the fixture's param)."""
    name = request.param
    if name in ("ell", "segment"):
        monkeypatch.setattr(jspmv, "DENSE_MAX_ELEMS", 0)
        monkeypatch.setattr(tspmv, "DENSE_MAX_ELEMS", 0)
    if name == "segment":
        def no_ell(self, A):
            self.ell = False
        monkeypatch.setattr(jspmv.SpMVPlan, "_build_ell", no_ell)
        monkeypatch.setattr(tspmv.SpMVPlan, "_build_ell", no_ell)
    return name


CASES = {"dia": lambda: laplace2d(9),
         "densify": lambda: sp.random(70, 60, 0.05, format="csr",
                                      random_state=np.random.default_rng(3)),
         "ell": lambda: with_long_rows(90, 80, 4),
         "segment": lambda: with_long_rows(50, 40, 5)}


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("engine", list(CASES), indirect=True)
def test_spmm_engines(S, engine):
    """A @ B on each engine: B on A's column partition, and B on an uneven
    partition (the exchange moves B's rows whole)."""
    A = CASES[engine]()
    ht.clear_plan_cache()
    hl.clear_plan_cache()
    B = np.random.default_rng(6).standard_normal((A.shape[1], 5))
    Aj, At = sparse_both(A, S)
    m = A.shape[1]
    uneven = np.array([0] + [min(m, 3 + 7 * s) for s in range(1, S)] + [m])
    for p in (None, uneven):
        Bj, Bt = dense_both(B, S, p)
        Ct = At @ Bt
        _same(Ct, Aj @ Bj, A @ B)
        pt = tspmv.get_spmm_plan(At, Bt)
        pj = jspmv.get_spmv_plan(Aj, hl.DistVector.from_global(
            B[:, 0], backends(S)[0], partition=p))
        assert _engine(pt) == _engine(pj) == engine
        if engine == "ell":
            assert pt.ell_Tpad > 0, "the case must have a COO tail"


@pytest.mark.parametrize("S", [2, 4])
def test_spmm_ell_identity_exchange(S, monkeypatch):
    """A block-diagonal A reads only its own shard's rows of B: the
    exchange is the identity and the ELL engine reads B's stack directly."""
    monkeypatch.setattr(jspmv, "DENSE_MAX_ELEMS", 0)
    monkeypatch.setattr(tspmv, "DENSE_MAX_ELEMS", 0)
    blocks = [sp.random(10, 10, 0.3, random_state=np.random.default_rng(s))
              + sp.eye(10) for s in range(S)]
    A = sp.block_diag(blocks, format="csr")
    B = np.random.default_rng(7).standard_normal((10 * S, 3))
    Aj, At = sparse_both(A, S)
    Bj, Bt = dense_both(B, S)
    assert tspmv.get_spmm_plan(At, Bt).exchange.is_identity
    _same(At @ Bt, Aj @ Bj, A @ B)


def test_spmm_raw_tables_are_checked(monkeypatch):
    """At one shard the ELL tables are composed with the compressed-column
    map and checked against B's rows; dead slots carry zero values."""
    monkeypatch.setattr(tspmv, "DENSE_MAX_ELEMS", 0)
    A = with_long_rows(60, 50, 8)
    bt = ht.backend_auto(1, device="cpu")
    At = ht.DistSparseMatrix.from_scipy(A, bt)
    Bt = ht.DistDenseMatrix.from_global(np.ones((50, 2)), bt)
    plan = tspmv.get_spmm_plan(At, Bt)
    raw = tspmv._ell_cols_raw(At, plan)
    assert int(raw.max()) < 50
    assert tspmv._ell_cols_raw(At, plan) is raw   # cached on the plan
    vals, _ = tspmv._ell_values(At, plan)
    ci = At.structure.col_indices[0]
    dead = np.asarray(vals[0].reshape(-1)) == 0
    np.testing.assert_array_equal(raw[0].numpy()[dead], ci[0])
    plan.ell_cols_np = plan.ell_cols_np.copy()
    plan.ell_cols_np[0, 0] = len(ci)      # one past the map: out of range
    del plan._ell_cols_raw
    with pytest.raises(IndexError):
        tspmv._ell_cols_raw(At, plan)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("densify", [True, False])
def test_dense_times_sparse(S, densify, monkeypatch):
    """D @ A on both arms: A's values scattered into a dense block, or
    (Aᵀ Dᵀ)ᵀ through the transposes when the block is over the cap."""
    if not densify:
        monkeypatch.setattr(jmixed, "DXS_DENSIFY_MAX_ELEMS", 0)
        monkeypatch.setattr(tmixed, "DXS_DENSIFY_MAX_ELEMS", 0)
    A = sp.random(30, 22, 0.2, format="csr",
                  random_state=np.random.default_rng(9))
    D = np.random.default_rng(10).standard_normal((17, 30))
    Aj, At = sparse_both(A, S)
    Dj, Dt = dense_both(D, S)
    _same(Dt @ At, Dj @ Aj, D @ A.toarray())
    with pytest.raises(ValueError, match="dimension mismatch"):
        Dt @ sparse_both(A.T.tocsr(), S)[1]


@pytest.mark.parametrize("S", SHARDS)
def test_lazy_dense_rules(S):
    """Dᵀx without materialising, vᵀD, DᵀE, Aᵀ D and DᵀA (ref
    lazy.py's dense rules)."""
    rng = np.random.default_rng(11)
    D = rng.standard_normal((19, 7))
    E = rng.standard_normal((19, 4))
    A = sp.random(19, 12, 0.3, format="csr", random_state=rng)
    x = rng.standard_normal(19)
    (Dj, Dt), (Ej, Et) = dense_both(D, S), dense_both(E, S)
    Aj, At = sparse_both(A, S)
    xj = hl.DistVector.from_global(x, backends(S)[0])
    xt = ht.DistVector.from_global(x, backends(S)[1])
    y = Dt.T @ xt
    assert isinstance(y, ht.DistVector)
    _close(y.data.numpy(), np.asarray((Dj.T @ xj).data))
    _close(y.to_numpy(), D.T @ x)
    r = xt.T @ Dt
    assert isinstance(r, ht.LazyTranspose)
    _close(r.T.to_numpy(), x @ D)
    _close(r.to_numpy(), (xj.T @ Dj).to_numpy())
    _same(Dt.T @ Et, Dj.T @ Ej, D.T @ E)
    _same(At.T @ Et, Aj.T @ Ej, A.T @ E)
    _same(Dt.T @ At, Dj.T @ Aj, D.T @ A.toarray())


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("symmetric", [True, False])
def test_solve_dense_rhs(S, symmetric):
    """solve(A, B) with a DistDenseMatrix B: one multi-RHS sweep, the
    result a DistDenseMatrix on A's row partition (ref api.py:402-432,
    :605-612); transposed solves through the keyword and through A.T."""
    rng = np.random.default_rng(12 + symmetric)
    A = laplace2d(6) + sp.eye(36)
    if not symmetric:
        A = (A + 0.2 * sp.random(36, 36, 0.05, random_state=rng)).tocsr()
    A = sp.csr_matrix(A)
    B = rng.standard_normal((36, 3))
    Aj, At = sparse_both(A, S)
    Bj, Bt = dense_both(B, S, np.array([0] * S + [36]))
    ht.clear_plan_cache("backslash")
    X = ht.solve(At, Bt)
    assert isinstance(X, ht.DistDenseMatrix)
    np.testing.assert_array_equal(X.row_partition, At.row_partition)
    Xj = hl.solve(Aj, Bj)
    _close(X.to_numpy(), Xj.to_numpy())
    np.testing.assert_allclose(A @ X.to_numpy(), B, atol=1e-10)
    for Y in (ht.solve(At, Bt, transpose=True), ht.solve(At.T, Bt)):
        _close(Y.to_numpy(), hl.solve(Aj.T, Bj).to_numpy())
    F = ht.lu(At)
    Xh = F.solve_matrix(B)
    assert isinstance(Xh, np.ndarray)
    np.testing.assert_allclose(A @ Xh, B, atol=1e-10)
