"""The port's transpose, lazy transpose, addition, diagonal, builder,
repartition and SpGEMM plans against the JAX package's.

The same scipy inputs, made with numpy from a seed, go through both
packages at the suite's shard counts in f64. The checks:
  * structures equal array for array and hash for hash (``_same``);
  * values within rtol 1e-12 of the largest |value| — the JAX segment sums
    and torch's ``index_add_``/``scatter_add_`` add in different orders;
  * the engine each plan chose is the JAX package's.
The cases mirror tests/test_transpose.py, test_lazy_transpose.py,
test_addition.py, test_addition_different_sparsity.py,
test_matrix_multiplication.py and the builder and diagonal cases of the
JAX suite.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg.ops.spgemm as jspgemm
import hpclinalg_torch as ht
import hpclinalg_torch.ops.spgemm as tspgemm
from hpclinalg_torch.utils.convert import from_reference

torch.set_num_threads(1)

SHARDS = [1, 4, 8]
RTOL = 1e-12


def rand(m, n, density, seed):
    return sp.random(m, n, density, format="csr",
                     random_state=np.random.default_rng(seed))


def tridiag(n):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    return (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k))).tocsr()


def both(A, S, row_partition=None):
    """(JAX matrix, port matrix) of scipy ``A`` on S shards."""
    p = None if row_partition is None else np.asarray(row_partition)
    return (hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(nshards=S),
                                           row_partition=p),
            ht.DistSparseMatrix.from_scipy(A, ht.backend_auto(S, device="cpu"),
                                           row_partition=p))


def vecs(x, S, partition=None):
    p = None if partition is None else np.asarray(partition)
    return (hl.DistVector.from_global(x, hl.backend_auto(nshards=S), partition=p),
            ht.DistVector.from_global(x, ht.backend_auto(S, device="cpu"),
                                      partition=p))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(1.0, float(np.abs(want).max(
                                   initial=0.0))))


def _same(Mt, Mj, ref=None):
    """Port matrix ``Mt`` equals JAX matrix ``Mj``: structure, hash, values
    (and the scipy ``ref`` when given)."""
    st, sj = Mt.structure, Mj.structure
    for a in ("row_partition", "col_partition"):
        np.testing.assert_array_equal(getattr(st, a), getattr(sj, a))
    for a in ("indptr", "col_indices", "colval"):
        for x, y in zip(getattr(st, a), getattr(sj, a)):
            np.testing.assert_array_equal(x, y)
    assert Mt.hash == Mj.hash
    _close(Mt.nzval.numpy(), np.asarray(Mj.nzval))
    if ref is not None:
        _close(Mt.to_scipy().toarray(), sp.csr_matrix(ref).toarray())


def _same_vec(vt, vj, ref=None):
    np.testing.assert_array_equal(vt.partition, vj.partition)
    _close(vt.data.numpy(), np.asarray(vj.data))
    if ref is not None:
        _close(vt.to_numpy(), ref)


# -- transpose -----------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_transpose_materialize(S):
    A = rand(23, 17, 0.25, 31)
    Aj, At = both(A, S)
    T = At.transpose_materialized()
    _same(T, Aj.transpose_materialized(), A.T)
    assert T.transpose_materialized() is At      # bidirectional cache
    assert At.transpose_materialized() is T
    assert At.T.T is At
    B = At * 3.0                                  # same pattern: plan reused
    n0 = ht.cache_sizes()["transpose_plan"]
    assert B.transpose_materialized().hash == T.hash
    assert ht.cache_sizes()["transpose_plan"] == n0


def test_transpose_empty_shards():
    A = rand(10, 16, 0.3, 31)
    Aj, At = both(A, 4, row_partition=[0, 4, 4, 4, 10])
    _same(At.transpose_materialized(), Aj.transpose_materialized(), A.T)


# -- lazy transpose --------------------------------------------------------------

def _ref_C():
    i = np.array([1, 2, 3, 4, 5, 6, 7, 8, 1, 3]) - 1
    j = np.array([1, 2, 3, 4, 5, 6, 1, 2, 3, 4]) - 1
    return sp.csr_matrix((np.arange(1.0, 11.0), (i, j)), shape=(8, 6))


def _ref_D():
    i = np.array([1, 2, 3, 4, 5, 6, 1, 2]) - 1
    j = np.array([1, 2, 3, 4, 5, 6, 7, 8]) - 1
    return sp.csr_matrix((np.arange(1.0, 9.0), (i, j)), shape=(6, 8))


@pytest.mark.parametrize("S", SHARDS)
def test_lazy_transpose_products(S):
    A, B = rand(16, 12, 0.3, 31), rand(12, 16, 0.3, 32)
    (Aj, At), (Bj, Bt) = both(A, S), both(B, S)
    Z = At.T @ Bt.T                    # Aᵀ Bᵀ = (B A)ᵀ stays lazy
    assert isinstance(Z, ht.LazyTranspose)
    _same(Z.materialize(), (Aj.T @ Bj.T).materialize(), A.T @ B.T)
    _same(At.T @ At, Aj.T @ Aj, A.T @ A)
    _same(At @ At.T, Aj @ Aj.T, A @ A.T)
    x = np.random.default_rng(3).standard_normal(16)
    xj, xt = vecs(x, S)
    _same_vec(At.T @ xt, Aj.T @ xj, A.T @ x)


@pytest.mark.parametrize("S", SHARDS)
def test_lazy_reference_patterns(S):
    C, D = _ref_C(), _ref_D()
    (Cj, Ct), (Dj, Dt) = both(C, S), both(D, S)
    Z = Ct.T @ Dt.T
    assert isinstance(Z, ht.LazyTranspose)
    _same(Z.materialize(), (Cj.T @ Dj.T).materialize(), (D @ C).T)
    Sm = (C @ C.T).tocsr()
    Sj, St = both(Sm, S)
    for got, want, ref in ((St + St.T, Sj + Sj.T, Sm + Sm.T),
                           (St - St.T, Sj - Sj.T, Sm - Sm.T),
                           (St.T + St, Sj.T + Sj, Sm.T + Sm),
                           (St.T - St, Sj.T - Sj, Sm.T - Sm)):
        _same(got, want, ref)
    _same((St.T + St.T).materialize(), (Sj.T + Sj.T).materialize(), 2 * Sm.T)


@pytest.mark.parametrize("S", SHARDS)
def test_lazy_scalar_and_row_vector_rules(S):
    C = _ref_C()
    Cj, Ct = both(C, S)
    for Z, ref in ((Ct.T * 2.5, 2.5 * C.T), (2.5 * Ct.T, 2.5 * C.T),
                   (Ct.T / 4.0, C.T / 4.0), (-Ct.T, -C.T)):
        assert isinstance(Z, ht.LazyTranspose)
        _close(Z.materialize().to_scipy().toarray(), ref.toarray())
    _close(Ct.T.to_scipy().toarray(), C.T.toarray())
    v = np.arange(1.0, 9.0)
    w = np.linspace(-1.0, 1.0, 8)
    vj, vt = vecs(v, S)
    wj, wt = vecs(w, S)
    _close(float(vt.T @ wt), float(vj.T @ wj))          # vᵀw, no conjugate
    R = vt.T @ Ct                                       # vᵀC = (Cᵀ v)ᵀ
    assert isinstance(R, ht.LazyTranspose) and R.shape == (1, 6)
    _same_vec(R.T, (vj.T @ Cj).T, v @ C)
    u = np.arange(6.0)
    uj, ut = vecs(u, S)
    _same_vec((ut.T @ Ct.T).T, (uj.T @ Cj.T).T, C @ u)  # uᵀCᵀ = (C u)ᵀ
    with pytest.raises(TypeError, match="row vector"):
        vt.T.materialize()


# -- addition ----------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_addition_same_and_different_sparsity(S):
    T = tridiag(28)
    Tj, Tt = both(T, S)
    _same(Tt + Tt * 2.0, Tj + Tj * 2.0, 3 * T)
    _same(Tt - Tt * 2.0, Tj - Tj * 2.0, -T)
    A, B = rand(25, 25, 0.15, 41), rand(25, 25, 0.15, 42)
    (Aj, At), (Bj, Bt) = both(A, S), both(B, S)
    _same(At + Bt, Aj + Bj, A + B)
    _same(At - Bt, Aj - Bj, A - B)


def test_addition_disjoint_mismatched_and_reuse():
    A = sp.csr_matrix(sp.triu(rand(20, 20, 0.2, 43), 1))
    B = sp.csr_matrix(sp.tril(rand(20, 20, 0.2, 44), -1))
    (Aj, At), (Bj, Bt) = both(A, 4), both(B, 4)
    _same(At + Bt, Aj + Bj, A + B)
    A, B = rand(22, 22, 0.2, 45), rand(22, 22, 0.2, 46)
    Aj, At = both(A, 4)
    Bj, Bt = both(B, 4, row_partition=[0, 2, 11, 20, 22])
    _same(At + Bt, Aj + Bj, A + B)   # B is repartitioned onto A's rows
    n0 = ht.cache_sizes().get("addition_plan", 0)
    At + Bt
    (At * 2.0) + (Bt * 3.0)          # the same structures: one plan
    assert ht.cache_sizes().get("addition_plan", 0) == n0


@pytest.mark.parametrize("S", SHARDS)
def test_add_identity(S):
    T = tridiag(24)
    Tj, Tt = both(T, S)
    C = Tt.add_identity(2.5)
    assert C.structure is Tt.structure   # fast path shares the pattern
    _same(C, Tj.add_identity(2.5), T + 2.5 * sp.eye(24))
    A = sp.csr_matrix(sp.triu(rand(18, 18, 0.2, 47), 1))
    Aj, At = both(A, S)
    _same(At.add_identity(-1.5), Aj.add_identity(-1.5), A - 1.5 * sp.eye(18))


def test_add_identity_complex_shift():
    A = sp.csr_matrix(np.diag(np.ones(11), 1))
    At = ht.DistSparseMatrix.from_scipy(A, ht.backend_auto(4, device="cpu"))
    D = At.add_identity(2j)
    assert D.dtype == torch.complex128
    np.testing.assert_allclose(D.to_scipy().toarray(),
                               A.toarray() + 2j * np.eye(12))


def _sd(n, pairs):
    return sp.diags([v for _, v in pairs], [k for k, _ in pairs],
                    shape=(n, n)).tocsr()


@pytest.mark.parametrize("S", SHARDS)
def test_addition_of_spgemm_products(S):
    """The FEM-operator and Hessian-style chains of
    test_addition_different_sparsity.py: SpGEMMs of different structures,
    then additions across their patterns."""
    n = 8
    dx = _sd(n, [(0, -np.ones(n)), (1, np.ones(n - 1))]).tolil()
    dx[n - 1, n - 1] = 0
    dx = sp.csr_matrix(dx)
    ident, w = _sd(n, [(0, np.ones(n))]), _sd(n, [(0, 0.5 * np.ones(n))])
    (Dj, Dt), (Ij, It), (Wj, Wt) = both(dx, S), both(ident, S), both(w, S)
    _same(It.T @ Wt @ Dt + Dt.T @ Wt @ It, Ij.T @ Wj @ Dj + Dj.T @ Wj @ Ij,
          ident.T @ w @ dx + dx.T @ w @ ident)
    Ht = Dt.T @ Wt @ Dt + It.T @ Wt @ It
    Hj = Dj.T @ Wj @ Dj + Ij.T @ Wj @ Ij
    Ht = Ht + (Dt.T @ Wt @ It + It.T @ Wt @ Dt)
    Hj = Hj + (Dj.T @ Wj @ Ij + Ij.T @ Wj @ Dj)
    _same(Ht, Hj, dx.T @ w @ dx + ident.T @ w @ ident + dx.T @ w @ ident
          + ident.T @ w @ dx)
    f1, f2 = _sd(n, [(0, 0.3 * np.ones(n))]), _sd(n, [(0, 0.7 * np.ones(n))])
    (F1j, F1t), (F2j, F2t) = both(f1, S), both(f2, S)
    _same(F1t @ Dt + Dt.T @ F2t, F1j @ Dj + Dj.T @ F2j, f1 @ dx + dx.T @ f2)


# -- builders ----------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_builders(S):
    bj, bt = hl.backend_auto(nshards=S), ht.backend_auto(S, device="cpu")
    _same(ht.speye(13, bt), hl.speye(13, bj), sp.eye(13))
    _same(ht.spzeros(9, 7, bt), hl.spzeros(9, 7, bj), sp.csr_matrix((9, 7)))
    _same(ht.sprand_dist(30, 20, 0.2, bt, seed=5),
          hl.sprand_dist(30, 20, 0.2, bj, seed=5),
          rand(30, 20, 0.2, 5))
    n = 10
    d0, d1, d2 = np.arange(1.0, n + 1), np.ones(n - 1), 0.5 * np.ones(n - 2)
    (v0j, v0t), (v1j, v1t), (v2j, v2t) = vecs(d0, S), vecs(d1, S), vecs(d2, S)
    _same(ht.spdiagm(v0t), hl.spdiagm(v0j), sp.diags(d0))           # main only
    _same(ht.spdiagm((-1, v1t), (0, v0t), (1, v1t), (2, v2t)),
          hl.spdiagm((-1, v1j), (0, v0j), (1, v1j), (2, v2j)),
          sp.diags([d1, d0, d1, d2], [-1, 0, 1, 2]))
    _same(ht.spdiagm((1, v1t), (1, v1t)), hl.spdiagm((1, v1j), (1, v1j)),
          sp.diags([2 * d1], [1], shape=(n, n)))                    # sums


# -- diag / triu / tril / dropzeros ----------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_diagonal_ops(S):
    A = rand(19, 15, 0.3, 51)
    Aj, At = both(A, S)
    Ad = A.toarray()
    for k in (-2, 0, 3):
        _same_vec(At.diag(k), Aj.diag(k), np.diag(Ad, k))
        _same(At.triu(k), Aj.triu(k), np.triu(Ad, k))
        _same(At.tril(k), Aj.tril(k), np.tril(Ad, k))
    _same_vec(ht.diag(At, 1), Aj.diag(1))
    _same(ht.triu(At), Aj.triu())
    _same(ht.tril(At), Aj.tril())
    Z = A.copy()
    Z.data[::3] = 0.0                   # explicit zeros stay stored
    Z.data[1::3] *= 1e-3
    Zj, Zt = both(Z, S)
    assert Zt.nnz() == Z.nnz
    _same(Zt.dropzeros(), Zj.dropzeros(), Z)
    _same(ht.dropzeros(Zt, 1e-2), Zj.dropzeros(1e-2))


# -- repartition -------------------------------------------------------------------

@pytest.mark.parametrize("part", [[0, 0, 5, 5, 12], [0, 1, 2, 3, 12],
                                  [0, 6, 12, 12, 12]])
def test_repartition(part):
    x = np.arange(12.0)
    xj, xt = vecs(x, 4)
    _same_vec(ht.repartition(xt, part), hl.repartition_vector(xj, np.array(part)),
              x)
    yt = ht.DistVector.from_global(2 * x, xt.backend, partition=part)
    _same_vec(xt + yt, xj + hl.DistVector.from_global(
        2 * x, xj.backend, partition=np.array(part)), 3 * x)  # aligned
    A = rand(12, 9, 0.4, 61)
    Aj, At = both(A, 4)
    R = ht.repartition(At, part)
    _same(R, Aj.repartition(np.array(part)), A)
    assert ht.repartition(At, At.row_partition) is At


# -- SpGEMM ----------------------------------------------------------------------

def _engines(Ct_plan, Cj_plan):
    assert Ct_plan.densify == Cj_plan.densify
    assert Ct_plan.dia.ok == Cj_plan.dia.ok
    assert Ct_plan.nchunks == Cj_plan.nchunks
    assert Ct_plan.gpad == Cj_plan.gpad


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("case", ["square", "nonsquare", "ata", "stencil"])
def test_spgemm(S, case):
    if case == "square":
        A, B = tridiag(26), rand(26, 26, 0.2, 21)
    elif case == "nonsquare":
        A, B = rand(14, 22, 0.3, 22), rand(22, 9, 0.3, 23)
    elif case == "ata":
        A = rand(40, 12, 0.2, 24)
        A, B = A.T.tocsr(), A
    else:
        A = B = laplace2d(12)
    (Aj, At), (Bj, Bt) = both(A, S), both(B, S)
    _same(At @ Bt, Aj @ Bj, A @ B)
    _engines(tspgemm.get_spgemm_plan(At, Bt), jspgemm.get_spgemm_plan(Aj, Bj))
    if case == "stencil":
        assert tspgemm.get_spgemm_plan(At, Bt).dia.ok


@pytest.mark.parametrize("S", SHARDS)
def test_spgemm_pair_engine_chunked(S, monkeypatch):
    """The pair engine (densify off) in one chunk and in several: C equals
    the JAX package's densify/pair result either way."""
    A, B = rand(30, 24, 0.25, 25), rand(24, 27, 0.25, 26)
    (Aj, At), (Bj, Bt) = both(A, S), both(B, S)
    Cj = Aj @ Bj
    monkeypatch.setattr(tspgemm, "DENSE_SPGEMM_ELEMS", 0)
    plan = tspgemm.get_spgemm_plan(At, Bt)
    assert not plan.densify and not plan.dia.ok and plan.nchunks == 1
    _same(At @ Bt, Cj, A @ B)
    monkeypatch.setattr(tspgemm, "PAIR_CAP", 16)
    ht.clear_plan_cache("matrix_plan")
    with pytest.warns(RuntimeWarning, match="chunks"):
        plan = tspgemm.get_spgemm_plan(At, Bt)
    assert plan.nchunks > 1
    _same(At @ Bt, Cj, A @ B)
    ht.clear_plan_cache("matrix_plan")


def test_spgemm_chain_reuse_and_empty():
    A, B, C = rand(12, 18, 0.3, 25), rand(18, 15, 0.3, 26), rand(15, 7, 0.4, 27)
    (Aj, At), (Bj, Bt), (Cj, Ct) = both(A, 4), both(B, 4), both(C, 4)
    _same(At @ Bt @ Ct, Aj @ Bj @ Cj, A @ B @ C)
    R = rand(20, 20, 0.25, 24)
    Rj, Rt = both(R, 4)
    n0 = ht.cache_sizes().get("matrix_plan", 0)
    Rt @ Rt
    R3 = Rt * 3.0                        # same structure object
    _same(R3 @ R3, (Rj * 3.0) @ (Rj * 3.0), 9 * (R @ R))
    assert ht.cache_sizes().get("matrix_plan", 0) == n0 + 1
    E = sp.csr_matrix((np.ones(3), ([0, 1, 2], [0, 1, 2])), shape=(10, 10))
    F = sp.csr_matrix((np.ones(2), ([7, 8], [3, 4])), shape=(10, 10))
    (Ej, Et), (Fj, Ft) = both(E, 4), both(F, 4)
    Z = Et @ Ft
    assert Z.nnz() == 0 and Z.shape == (10, 10)
    _same(Z, Ej @ Fj)
    # the JAX package's own SpGEMM test counts its plan cache's growth on R's
    # pattern; leave no JAX plan behind for a later test of the process
    hl.clear_plan_cache("matrix_plan")


def test_spgemm_mismatched_partitions():
    A, B = rand(18, 18, 0.25, 33), rand(18, 18, 0.25, 34)
    Aj, At = both(A, 4, row_partition=[0, 2, 9, 14, 18])
    Bj, Bt = both(B, 4, row_partition=[0, 5, 10, 15, 18])
    C = At @ Bt
    _same(C, Aj @ Bj, A @ B)
    np.testing.assert_array_equal(C.row_partition, At.row_partition)


@pytest.mark.parametrize("S", SHARDS)
def test_spgemm_identity_and_diagonal(S):
    A = rand(13, 13, 0.3, 35)
    Aj, At = both(A, S)
    bj, bt = Aj.backend, At.backend
    Ij, It = hl.speye(13, bj), ht.speye(13, bt)
    _same(At @ It, Aj @ Ij, A)
    _same(It @ At, Ij @ Aj, A)
    d = np.arange(1.0, 14.0)
    dj, dt = vecs(d, S)
    Dj, Dt = hl.spdiagm((0, dj)), ht.spdiagm((0, dt))
    _same(At @ Dt, Aj @ Dj, A @ sp.diags(d))
    _same(Dt @ At, Dj @ Aj, sp.diags(d) @ A)


# -- carrying JAX results across ---------------------------------------------------

@pytest.mark.parametrize("S", [1, 4])
def test_from_reference_keeps_derived_structures(S):
    """JAX matrices made by transpose, addition and SpGEMM convert with
    their structure and hash, and the port computes on them."""
    A = rand(20, 14, 0.25, 71)
    Aj, At = both(A, S)
    bt = At.backend
    Tj = Aj.transpose_materialized()
    Nj = (Tj @ Aj).add_identity(0.5)
    Sj = Nj + Nj.triu(1)
    for Mj in (Tj, Nj, Sj):
        Mt = from_reference(bt, Mj)
        assert Mt.hash == Mj.hash
        _same(Mt, Mj)
    _same(from_reference(bt, Nj), (At.T @ At).add_identity(0.5))
    x = np.linspace(0.0, 1.0, 14)
    xj, xt = vecs(x, S)
    vt = from_reference(bt, Nj @ xj)
    _same_vec(vt, Nj @ xj)
    _same_vec(from_reference(bt, Nj) @ xt, Nj @ xj)


def test_transpose_cache_leaves_no_cycle():
    """A matrix and its materialised transpose are freed by reference
    counting alone: the transpose's link back is weak, so dropped matrices
    do not keep their device memory until a cyclic collection."""
    import gc
    import weakref

    At = ht.DistSparseMatrix.from_scipy(rand(12, 9, 0.3, 81),
                                        ht.backend_auto(2, device="cpu"))
    gc.disable()
    try:
        B = At.with_values(At.nzval * 2.0)
        T = B.transpose_materialized()
        assert T.transpose_materialized() is B
        refs = weakref.ref(B), weakref.ref(T)
        del B, T
        assert refs[0]() is None and refs[1]() is None
    finally:
        gc.enable()
