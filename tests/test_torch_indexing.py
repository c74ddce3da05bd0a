"""The port's indexing and index assignment against the JAX package's:
the 24 scenarios of tests/test_indexing.py, each run through both
packages on the same seeded input, plus the stale-cache case (A @ x, A.T
@ x and solve(A, b) after a sparse assignment, against scipy) and the
swap semantics of vector assignment.

Data movement is compared bit for bit (values, partitions, hashes); the
configurations are f64 at S = 1, 4 and 8 and c128 at S = 4, and every
input is laid out on a partition with an empty shard when S > 1.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from utils import dense_matrix, rand_vector, random_sparse

torch.set_num_threads(1)

CONFIGS = [(np.float64, 1), (np.float64, 4), (np.complex128, 4),
           (np.float64, 8)]
IDS = ["f64-serial", "f64-4shards", "c128-4shards", "f64-8shards"]


def parted(n, S):
    """A partition of n rows over S shards with shard 1 empty (S > 1)."""
    if S == 1:
        return np.array([0, n])
    p = ht.uniform_partition(n, S - 1)
    return np.concatenate([p[:1], p[:1], p[1:]])


class Pair:
    """One backend of each package at shard count S and dtype."""

    def __init__(self, S, dtype=np.float64):
        self.S, self.dtype = S, dtype
        self.bj = hl.backend_auto(nshards=S, dtype=dtype)
        self.bt = ht.backend_auto(S, dtype=dtype, device="cpu")

    def vec(self, x, partition=None, dtype=None):
        dt = dtype or self.dtype
        p = parted(len(x), self.S) if partition is None else partition
        return (hl.DistVector.from_global(x, self.bj, partition=p, dtype=dt),
                ht.DistVector.from_global(x, self.bt, partition=p, dtype=dt))

    def sparse(self, A):
        p = parted(A.shape[0], self.S)
        return (hl.DistSparseMatrix.from_scipy(A, self.bj, row_partition=p,
                                               dtype=self.dtype),
                ht.DistSparseMatrix.from_scipy(A, self.bt, row_partition=p,
                                               dtype=self.dtype))

    def dense(self, M):
        p = parted(M.shape[0], self.S)
        return (hl.DistDenseMatrix.from_global(M, self.bj, row_partition=p,
                                               dtype=self.dtype),
                ht.DistDenseMatrix.from_global(M, self.bt, row_partition=p,
                                               dtype=self.dtype))


def same_vec(vt, vj):
    assert isinstance(vt, ht.DistVector)
    assert np.array_equal(vt.partition, vj.partition)
    np.testing.assert_array_equal(vt.to_numpy(), np.asarray(vj.to_numpy()))
    m = ht.partition.shard_mask(vt.partition, vt.L)
    assert np.all(vt.data.numpy()[~m] == 0), "padding not zero"


def same_sparse(Mt, Mj):
    assert isinstance(Mt, ht.DistSparseMatrix)
    assert Mt.hash == Mj.hash
    st, sj = Mt.structure, Mj.structure
    assert np.array_equal(st.row_partition, sj.row_partition)
    assert np.array_equal(st.col_partition, sj.col_partition)
    for s in range(len(st.indptr)):
        assert np.array_equal(st.indptr[s], sj.indptr[s])
        assert np.array_equal(st.col_indices[s], sj.col_indices[s])
        assert np.array_equal(st.colval[s], sj.colval[s])
    nz = Mt.nzval.numpy()
    for s in range(nz.shape[0]):
        assert np.all(nz[s, st.nnz_local[s]:] == 0), "nzval padding not zero"
    np.testing.assert_array_equal(Mt.host_values(),
                                  np.asarray(Mj.to_scipy().data))


def same_dense(Mt, Mj):
    assert isinstance(Mt, ht.DistDenseMatrix)
    assert np.array_equal(Mt.row_partition, Mj.row_partition)
    assert Mt.shape == Mj.shape
    np.testing.assert_array_equal(Mt.to_numpy(), np.asarray(Mj.to_numpy()))
    m = ht.partition.shard_mask(Mt.row_partition, Mt.data.shape[1])
    assert np.all(Mt.data.numpy()[~m] == 0), "dense padding not zero"


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vector_slice(dtype, S):
    x = rand_vector(40, dtype)
    vj, vt = Pair(S, dtype).vec(x)
    for sl in (slice(3, 27), slice(0, 40), slice(5, 6), slice(2, 38, 3)):
        same_vec(vt[sl], vj[sl])
        np.testing.assert_array_equal(vt[sl].to_numpy(), x[sl])


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vector_fancy(dtype, S):
    P = Pair(S, dtype)
    x = rand_vector(30, dtype)
    vj, vt = P.vec(x)
    idx = np.array([4, 1, 28, 7, 7, 0])
    same_vec(vt[idx], vj[idx])
    # a distributed float index vector (ref indexing.jl:1339)
    ij, it = P.vec(idx.astype(np.float64), dtype=np.float64)
    same_vec(vt[it], vj[ij])
    assert np.array_equal(vt[it].partition, it.partition)
    # ids computed in floating point are rounded, not truncated
    ij, it = P.vec(idx - 1e-13 + 1e-15, dtype=np.float64)
    same_vec(vt[it], vj[ij])
    np.testing.assert_array_equal(vt[it].to_numpy(), x[idx])


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vector_setindex_slice(dtype, S):
    P = Pair(S, dtype)
    x = rand_vector(24, dtype)
    vj, vt = P.vec(x)
    vj[3:9] = 7.0
    vt[3:9] = 7.0
    same_vec(vt, vj)
    w = rand_vector(5, dtype, seed=71)
    wj, wt = P.vec(w)
    vj[10:15] = wj
    vt[10:15] = wt
    same_vec(vt, vj)
    xe = x.copy()
    xe[3:9], xe[10:15] = 7.0, w
    np.testing.assert_array_equal(vt.to_numpy(), xe)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_vector_setindex_fancy(S):
    vj, vt = Pair(S).vec(rand_vector(20))
    idx = np.array([2, 15, 9])
    vals = np.array([10.0, 20.0, 30.0])
    vj[idx] = vals
    vt[idx] = vals
    same_vec(vt, vj)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_vector_setindex_duplicate_ids(S):
    """Repeated ids: the last write wins in both packages."""
    x = rand_vector(20)
    vj, vt = Pair(S).vec(x)
    idx = np.array([4, 11, 4, 7, 11, 11])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    vj[idx] = vals
    vt[idx] = vals
    same_vec(vt, vj)
    xe = x.copy()
    for i, val in zip(idx, vals):
        xe[i] = val
    np.testing.assert_array_equal(vt.to_numpy(), xe)


def test_vector_setindex_swaps_the_tensor():
    """Assignment swaps in a fresh tensor: a tensor shared with another
    container (a from_local input's copy, a vector taken before) is never
    written, and the host cache is dropped."""
    be = ht.backend_auto(4, device="cpu")
    v = ht.DistVector.from_local([np.arange(3.0), np.zeros(0), np.ones(4),
                                  np.arange(2.0)], be)
    alias = ht.DistVector(v.data, v.partition, be)
    before = v.data.clone()
    old = v.data
    ro = v.to_numpy_ro()
    v[np.array([0, 4, 8])] = np.array([-1.0, -2.0, -3.0])
    assert v.data is not old
    assert torch.equal(alias.data, before) and torch.equal(old, before)
    assert v._host_cache is None
    expect = np.concatenate([np.arange(3.0), np.ones(4), np.arange(2.0)])
    np.testing.assert_array_equal(ro, expect)
    expect[[0, 4, 8]] = [-1.0, -2.0, -3.0]
    np.testing.assert_array_equal(v.to_numpy_ro(), expect)
    np.testing.assert_array_equal(v.to_numpy(), expect)


def test_scalar_indexing_rejected():
    P = Pair(4)
    vj, vt = P.vec(rand_vector(10))
    Aj, At = P.sparse(random_sparse(10, 10, 0.3, seed=72))
    for obj in (vj, vt):
        with pytest.raises(TypeError):
            obj[3]
    for obj in (Aj, At):
        with pytest.raises(TypeError):
            obj[3, 4]


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_sparse_range_indexing(dtype, S):
    A = random_sparse(30, 25, 0.2, dtype, seed=73)
    Aj, At = Pair(S, dtype).sparse(A)
    same_sparse(At[5:22, 3:20], Aj[5:22, 3:20])
    same_sparse(At[0:30, 10:11], Aj[0:30, 10:11])
    np.testing.assert_array_equal(At[5:22, 3:20].to_scipy().toarray(),
                                  A[5:22, 3:20].toarray())


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_sparse_fancy_indexing(dtype, S):
    A = random_sparse(20, 20, 0.3, dtype, seed=74)
    Aj, At = Pair(S, dtype).sparse(A)
    ridx = np.array([3, 11, 0, 19])
    cidx = np.array([5, 2, 18])
    same_sparse(At[ridx, cidx], Aj[ridx, cidx])
    same_sparse(At[4:16, cidx], Aj[4:16, cidx])
    same_sparse(At[ridx, 0:20], Aj[ridx, 0:20])
    np.testing.assert_array_equal(At[ridx, cidx].to_scipy().toarray(),
                                  A[np.ix_(ridx, cidx)].toarray())


@pytest.mark.parametrize("S", [1, 4, 8])
def test_sparse_fancy_with_distvector(S):
    P = Pair(S)
    Aj, At = P.sparse(random_sparse(18, 18, 0.3, seed=75))
    ij, it = P.vec(np.array([1.0, 7.0, 13.0]))
    same_sparse(At[it, 0:18], Aj[ij, 0:18])


def test_indexing_plan_reuse():
    vt = Pair(4).vec(rand_vector(32))[1]
    n0 = ht.cache_sizes().get("vec_getindex", 0)
    _ = vt[4:20]
    _ = vt[4:20]
    assert ht.cache_sizes().get("vec_getindex", 0) == n0 + 1


@pytest.mark.parametrize("S", [1, 4, 8])
def test_sparse_setindex(S):
    P = Pair(S)
    A = random_sparse(16, 16, 0.2, seed=76)
    Aj, At = P.sparse(A)
    h0 = At.hash
    Aj[2:6, 3:9] = 5.0
    At[2:6, 3:9] = 5.0
    same_sparse(At, Aj)
    assert At.hash != h0
    ref = A.tolil()
    ref[2:6, 3:9] = 5.0
    np.testing.assert_array_equal(At.to_scipy().toarray(), ref.toarray())
    x = rand_vector(16)
    xj, xt = P.vec(x)
    np.testing.assert_allclose((At @ xt).to_numpy(), ref.tocsr() @ x,
                               rtol=1e-12)
    np.testing.assert_allclose((At @ xt).to_numpy(),
                               np.asarray((Aj @ xj).to_numpy()), rtol=1e-12)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_sparse_setindex_block(S):
    P = Pair(S)
    A = random_sparse(14, 14, 0.25, seed=77)
    B = random_sparse(4, 5, 0.5, seed=78)
    Aj, At = P.sparse(A)
    Bj, Bt = P.sparse(B)
    Aj[1:5, 2:7] = Bj
    At[1:5, 2:7] = Bt
    same_sparse(At, Aj)
    ref = A.tolil()
    ref[1:5, 2:7] = B.toarray()
    np.testing.assert_array_equal(At.to_scipy().toarray(), ref.toarray())


@pytest.mark.parametrize("S", [1, 4, 8])
def test_dense_setindex(S):
    M = dense_matrix(12, 8)
    Mj, Mt = Pair(S).dense(M)
    Mj[3:7, 2:5] = -1.5
    Mt[3:7, 2:5] = -1.5
    same_dense(Mt, Mj)
    ridx = np.array([0, 10])
    vals = np.arange(16.0).reshape(2, 8)
    Mj[ridx, 0:8] = vals
    Mt[ridx, 0:8] = vals
    same_dense(Mt, Mj)
    ref = M.copy()
    ref[3:7, 2:5] = -1.5
    ref[ridx] = vals
    np.testing.assert_array_equal(Mt.to_numpy(), ref)
    # repeated ids: the last write wins; a DistDenseMatrix value
    V = dense_matrix(3, 2, seed=5)
    Vj, Vt = Pair(S).dense(V)
    Mj[[1, 9, 1], [7, 0]] = Vj
    Mt[[1, 9, 1], [7, 0]] = Vt
    same_dense(Mt, Mj)


def test_sparse_setindex_large_local():
    """A 10 x 4 block into a 100k-row matrix: O(local nnz), never dense."""
    n = 100_000
    A = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.0)],
                 [-1, 0, 1], format="csr")
    P = Pair(4)
    At = ht.DistSparseMatrix.from_scipy(A, P.bt)
    Aj = hl.DistSparseMatrix.from_scipy(A, P.bj)
    At.transpose_materialized()
    rows = np.arange(500, 510)
    cols = np.array([3, 77, 4000, 99_999])
    V = np.arange(40, dtype=np.float64).reshape(10, 4) + 1.0
    At[rows, cols] = V
    Aj[rows, cols] = V
    same_sparse(At, Aj)
    ref = A.tolil()
    ref[np.ix_(rows, cols)] = V
    d = At.to_scipy() - ref.tocsr()
    assert (abs(d).max() if d.nnz else 0.0) == 0.0
    assert At.cached_transpose is None


@pytest.mark.parametrize("S", [1, 4, 8])
def test_sparse_setindex_duplicate_ids(S):
    A = random_sparse(12, 12, 0.4, seed=77)
    Aj, At = Pair(S).sparse(A)
    rows = np.array([2, 5, 2])
    cols = np.array([1, 3])
    V = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    Aj[rows, cols] = V
    At[rows, cols] = V
    same_sparse(At, Aj)
    ref = A.tolil()
    ref[np.ix_([5, 2], [1, 3])] = np.array([[3.0, 4.0], [5.0, 6.0]])
    d = At.to_scipy() - ref.tocsr()
    assert (abs(d).max() if d.nnz else 0.0) == 0.0
    # a DistSparseMatrix value (its values move device to device), with
    # repeated rows and columns
    Vs = sp.csr_matrix(np.array([[1.0, 0.0, 2.0], [0.0, 3.0, 0.0],
                                 [4.0, 5.0, 0.0]]))
    Vj, Vt = Pair(S).sparse(Vs)
    Aj[[7, 1, 7], [4, 9, 4]] = Vj
    At[[7, 1, 7], [4, 9, 4]] = Vt
    same_sparse(At, Aj)


@pytest.mark.parametrize("S", [1, 4])
def test_sparse_setindex_unsorted_rows(S):
    """A matrix whose local rows hold their columns out of order (built
    from local CSR blocks as given): the splice sorts such a shard whole
    and still equals the JAX package's."""
    rng = np.random.default_rng(81)
    parts = []
    for s in range(S):
        nl = 5
        cols = np.concatenate([rng.permutation(12)[:3] for _ in range(nl)])
        parts.append((np.arange(0, 3 * nl + 1, 3), cols,
                      rng.standard_normal(3 * nl)))
    At = ht.DistSparseMatrix.from_local_csr(parts, 12, Pair(S).bt)
    Aj = hl.DistSparseMatrix.from_local_csr(parts, 12, Pair(S).bj)
    assert At.hash == Aj.hash
    At[[1, 3], [0, 5, 7]] = 2.5
    Aj[[1, 3], [0, 5, 7]] = 2.5
    same_sparse(At, Aj)


def test_spgemm_pair_cap_chunks(monkeypatch):
    """Above PAIR_CAP the product runs in bounded chunks and still equals
    the JAX package's and scipy's."""
    import warnings

    import hpclinalg.ops.spgemm as spgemm_j
    import hpclinalg_torch.ops.spgemm as spgemm_t

    monkeypatch.setattr(spgemm_j, "PAIR_CAP", 256)
    monkeypatch.setattr(spgemm_t, "PAIR_CAP", 256)
    A = random_sparse(40, 40, 0.25, seed=411)
    B = random_sparse(40, 40, 0.25, seed=412)
    P = Pair(4)
    Aj, At = P.sparse(A)
    Bj, Bt = P.sparse(B)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        Ct, Cj = At @ Bt, Aj @ Bj
        assert spgemm_t.get_spgemm_plan(At, Bt).nchunks > 1
    assert Ct.hash == Cj.hash
    np.testing.assert_allclose(Ct.to_scipy().toarray(), (A @ B).toarray(),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_sparse_fancy_duplicates(S):
    """Repeated ids replicate rows and columns."""
    A = random_sparse(16, 14, 0.3, seed=79)
    Aj, At = Pair(S).sparse(A)
    ridx = np.array([2, 2, 9, 0, 2])
    cidx = np.array([3, 1, 1, 13])
    same_sparse(At[ridx, cidx], Aj[ridx, cidx])
    np.testing.assert_array_equal(At[ridx, cidx].to_scipy().toarray(),
                                  A.toarray()[np.ix_(ridx, cidx)])


def test_setindex_bounds_checked():
    P = Pair(4)
    At = ht.DistSparseMatrix.from_scipy(sp.eye(10).tocsr(), P.bt)
    Mt = ht.DistDenseMatrix.from_global(np.zeros((10, 10)), P.bt)
    for bad_r, bad_c in (([10], [0]), ([0], [10]), ([-1], [0]), ([0], [-1])):
        with pytest.raises(IndexError):
            At[bad_r, bad_c] = 1.0
        with pytest.raises(IndexError):
            Mt[bad_r, bad_c] = 1.0
    vt = P.vec(rand_vector(10))[1]
    with pytest.raises(IndexError):
        vt[np.array([10])] = 1.0
    with pytest.raises(IndexError):
        vt[np.array([-1])]


def test_setindex_complex_into_real_raises():
    P = Pair(4)
    At = ht.DistSparseMatrix.from_scipy(sp.eye(10).tocsr(), P.bt)
    Mt = ht.DistDenseMatrix.from_global(np.zeros((10, 10)), P.bt)
    with pytest.raises(TypeError):
        At[[0], [0]] = 1 + 2j
    with pytest.raises(TypeError):
        Mt[[0], [0]] = 1 + 2j


def test_int_index_bounds_checked():
    P = Pair(4)
    At = ht.DistSparseMatrix.from_scipy(sp.eye(8).tocsr(), P.bt)
    Mh = np.arange(32.0).reshape(8, 4)
    Mj, Mt = P.dense(Mh)
    for bad in (-1, 8):
        with pytest.raises(IndexError):
            At[:, bad]
        with pytest.raises(IndexError):
            At[bad, :]
    for bad in (-1, 4):
        with pytest.raises(IndexError):
            Mt[:, bad]
    same_vec(Mt[:, 2], Mj[:, 2])
    np.testing.assert_array_equal(Mt[:, 2].to_numpy(), Mh[:, 2])


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_sparse_row_and_col_to_vector(dtype, S):
    """A[:, k] and A[k, :] as DistVectors, with repeated ids."""
    A = random_sparse(15, 11, 0.35, dtype, seed=170)
    Aj, At = Pair(S, dtype).sparse(A)
    D = A.toarray()
    for key in ((slice(None), 4), (7, slice(None)), ([3, 9, 0, 9], 2),
                (5, [1, 10, 1])):
        got = At[key]
        assert isinstance(got, ht.DistVector)
        exp = Aj[key]
        assert np.array_equal(got.partition, exp.partition)
        np.testing.assert_allclose(got.to_numpy(), np.asarray(exp.to_numpy()),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(got.to_numpy(), D[key], rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_sparse_mixed_range_fancy(dtype, S):
    A = random_sparse(18, 14, 0.3, dtype, seed=171)
    Aj, At = Pair(S, dtype).sparse(A)
    same_sparse(At[2:15, [0, 5, 13, 5]], Aj[2:15, [0, 5, 13, 5]])
    same_sparse(At[[17, 4, 4, 11], 3:12], Aj[[17, 4, 4, 11], 3:12])


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_strided_slices(dtype, S):
    P = Pair(S, dtype)
    A = random_sparse(20, 20, 0.3, dtype, seed=172)
    Aj, At = P.sparse(A)
    same_sparse(At[::2, 1::3], Aj[::2, 1::3])
    vj, vt = P.vec(rand_vector(21, dtype, seed=173))
    same_vec(vt[2::4], vj[2::4])


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_dense_fancy_and_column(dtype, S):
    M = dense_matrix(16, 9, dtype, seed=174)
    Mj, Mt = Pair(S, dtype).dense(M)
    same_vec(Mt[:, 6], Mj[:, 6])
    same_vec(Mt[3, :], Mj[3, :])
    same_dense(Mt[[15, 2, 2, 8], :], Mj[[15, 2, 2, 8], :])
    same_dense(Mt[4:12, [8, 0, 3]], Mj[4:12, [8, 0, 3]])
    np.testing.assert_array_equal(Mt[4:12, [8, 0, 3]].to_numpy(),
                                  M[4:12][:, [8, 0, 3]])


@pytest.mark.parametrize("S", [1, 4])
def test_sparse_setindex_drops_stale_caches(S):
    """After a sparse assignment, A @ x, A.T @ x and solve(A, b) agree with
    scipy: no SpMV value table, transpose or factorization of the old
    matrix is reused. A value-only assignment keeps the hash and the
    backslash cache refactorizes."""
    n = 40
    L = (sp.diags([-np.ones(n - 1), 4 * np.ones(n), -np.ones(n - 1)],
                  [-1, 0, 1]) + sp.eye(n, k=5) + sp.eye(n, k=-5)).tocsr()
    P = Pair(S)
    At = ht.DistSparseMatrix.from_scipy(L, P.bt)
    x = rand_vector(n, seed=3)
    xt = ht.DistVector.from_global(x, P.bt)
    _ = At @ xt, At.T @ xt, ht.solve(At, xt), At.issymmetric()
    Tt = At.cached_transpose
    assert Tt is not None
    # a structural edit: unsymmetric, new pattern
    At[[3, 17], [9, 30]] = np.array([[0.5, 0.0], [2.0, 1.0]])
    ref = L.tolil()
    ref[np.ix_([3, 17], [9, 30])] = np.array([[0.5, 0.0], [2.0, 1.0]])
    ref = ref.tocsr()
    assert At.cached_transpose is None and Tt.cached_transpose is None
    assert not At.issymmetric()
    np.testing.assert_allclose((At @ xt).to_numpy(), ref @ x, rtol=1e-12)
    np.testing.assert_allclose((At.T @ xt).to_numpy(), ref.T @ x, rtol=1e-12)
    y = ht.solve(At, xt).to_numpy()
    np.testing.assert_allclose(ref @ y, x, rtol=1e-10, atol=1e-12)
    # a value-only edit on the same pattern: the same hash, new values
    h = At.hash
    cache = ht.BackslashCache._cache()
    ht.clear_plan_cache("backslash")
    ht.solve(At, xt)
    F = next(iter(cache.values()))
    At[[3], [9]] = np.array([[0.75]])
    ref[3, 9] = 0.75
    assert At.hash == h
    np.testing.assert_allclose((At @ xt).to_numpy(), ref @ x, rtol=1e-12)
    np.testing.assert_allclose((At.T @ xt).to_numpy(), ref.T @ x, rtol=1e-12)
    y = ht.solve(At, xt).to_numpy()
    assert len(cache) == 1 and next(iter(cache.values())) is F
    np.testing.assert_allclose(ref @ y, x, rtol=1e-10, atol=1e-12)
