"""The port's block operations against the JAX package's: the 16 scenarios
of tests/test_blocks.py through both packages on the same seeded blocks,
plus mixed-dtype promotion. Structures, hashes, partitions and values are
compared bit for bit; f64 at S = 1, 4 and 8 and c128 at S = 4, every input
on a partition with an empty shard when S > 1.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from test_torch_indexing import (CONFIGS, IDS, Pair, same_dense, same_sparse,
                                 same_vec)
from utils import dense_matrix, rand_vector, random_sparse

torch.set_num_threads(1)


def mk(P, m, n, seed, dtype=None):
    A = random_sparse(m, n, 0.3, dtype or P.dtype, seed=seed)
    return (A,) + P.sparse(A)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vcat(dtype, S):
    P = Pair(S, dtype)
    A, Aj, At = mk(P, 8, 10, 81)
    B, Bj, Bt = mk(P, 5, 10, 82)
    V = ht.vcat_sparse(At, Bt)
    same_sparse(V, hl.vcat_sparse(Aj, Bj))
    np.testing.assert_array_equal(V.to_scipy().toarray(),
                                  sp.vstack([A, B]).toarray())


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_hcat(dtype, S):
    P = Pair(S, dtype)
    A, Aj, At = mk(P, 9, 6, 83)
    B, Bj, Bt = mk(P, 9, 11, 84)
    H = ht.hcat_sparse(At, Bt)
    same_sparse(H, hl.hcat_sparse(Aj, Bj))
    np.testing.assert_array_equal(H.to_scipy().toarray(),
                                  sp.hstack([A, B]).toarray())


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_grid_cat(dtype, S):
    P = Pair(S, dtype)
    b = [mk(P, m, n, 85 + i) for i, (m, n) in
         enumerate([(7, 5), (7, 8), (4, 5), (4, 8)])]
    G = ht.cat_sparse(*[x[2] for x in b], dims=(2, 2))
    same_sparse(G, hl.cat_sparse(*[x[1] for x in b], dims=(2, 2)))
    ref = sp.bmat([[b[0][0], b[1][0]], [b[2][0], b[3][0]]]).toarray()
    np.testing.assert_array_equal(G.to_scipy().toarray(), ref)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_blockdiag(dtype, S):
    P = Pair(S, dtype)
    b = [mk(P, m, n, 89 + i) for i, (m, n) in enumerate([(6, 7), (4, 3),
                                                          (5, 5)])]
    BD = ht.blockdiag(*[x[2] for x in b])
    same_sparse(BD, hl.blockdiag(*[x[1] for x in b]))
    np.testing.assert_array_equal(BD.to_scipy().toarray(),
                                  sp.block_diag([x[0] for x in b]).toarray())


def test_blocks_plan_reuse():
    P = Pair(4)
    _, _, At = mk(P, 6, 6, 92)
    _, _, Bt = mk(P, 6, 6, 93)
    n0 = ht.cache_sizes().get("blocks_plan", 0)
    _ = ht.vcat_sparse(At, Bt)
    _ = ht.vcat_sparse(At * 2.0, Bt * 3.0)  # the same structures
    assert ht.cache_sizes().get("blocks_plan", 0) == n0 + 1


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_dense_vcat_hcat(dtype, S):
    P = Pair(S, dtype)
    A, B, C = (dense_matrix(m, n, dtype, seed=s) for m, n, s in
               ((7, 5, 21), (4, 5, 22), (7, 3, 23)))
    (Aj, At), (Bj, Bt), (Cj, Ct) = P.dense(A), P.dense(B), P.dense(C)
    same_dense(ht.vcat_dense(At, Bt), hl.vcat_dense(Aj, Bj))
    same_dense(ht.hcat_dense(At, Ct), hl.hcat_dense(Aj, Cj))
    np.testing.assert_array_equal(ht.vcat_dense(At, Bt).to_numpy(),
                                  np.vstack([A, B]))


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_dense_grid_cat(dtype, S):
    P = Pair(S, dtype)
    blocks = [dense_matrix(m, n, dtype, seed=30 + i)
              for i, (m, n) in enumerate([(6, 4), (6, 7), (3, 4), (3, 7)])]
    pairs = [P.dense(b) for b in blocks]
    G = ht.cat(*[t for _, t in pairs], dims=(2, 2))
    same_dense(G, hl.cat(*[j for j, _ in pairs], dims=(2, 2)))
    ref = np.block([[blocks[0], blocks[1]], [blocks[2], blocks[3]]])
    np.testing.assert_array_equal(G.to_numpy(), ref)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vector_cat(dtype, S):
    P = Pair(S, dtype)
    xs = [rand_vector(n, dtype, seed=s) for n, s in ((9, 41), (4, 42),
                                                      (13, 43))]
    pairs = [P.vec(x) for x in xs]
    V = ht.vcat_vectors(*[t for _, t in pairs])
    same_vec(V, hl.vcat_vectors(*[j for j, _ in pairs]))
    same_vec(ht.cat(*[t for _, t in pairs]), hl.cat(*[j for j, _ in pairs]))
    np.testing.assert_array_equal(V.to_numpy(), np.concatenate(xs))


def test_dense_cat_plan_reuse():
    P = Pair(4)
    At = P.dense(dense_matrix(6, 4, seed=51))[1]
    Bt = P.dense(dense_matrix(5, 4, seed=52))[1]
    n0 = ht.cache_sizes().get("dense_cat_rows", 0)
    _ = ht.vcat_dense(At, Bt)
    _ = ht.vcat_dense(At * 2.0, Bt * 3.0)  # the same partitions
    assert ht.cache_sizes().get("dense_cat_rows", 0) == n0 + 2


@pytest.mark.parametrize("S", [1, 4, 8])
def test_ops_on_cat_result(S):
    P = Pair(S)
    A, Aj, At = mk(P, 5, 9, 94)
    B, Bj, Bt = mk(P, 4, 9, 95)
    x = np.random.default_rng(96).standard_normal(9)
    xj, xt = P.vec(x)
    yt = (ht.vcat_sparse(At, Bt) @ xt).to_numpy()
    np.testing.assert_allclose(yt, sp.vstack([A, B]) @ x, rtol=1e-12)
    np.testing.assert_allclose(
        yt, np.asarray((hl.vcat_sparse(Aj, Bj) @ xj).to_numpy()), rtol=1e-12)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_grid_cat_3x2_2x3(dtype, S):
    P = Pair(S, dtype)
    for dims, shapes, seed in (((3, 2), [(5, 4), (5, 6), (3, 4), (3, 6),
                                         (7, 4), (7, 6)], 60),
                               ((2, 3), [(5, 4), (5, 6), (5, 3), (2, 4),
                                         (2, 6), (2, 3)], 70)):
        b = [mk(P, m, n, seed + i) for i, (m, n) in enumerate(shapes)]
        G = ht.cat_sparse(*[x[2] for x in b], dims=dims)
        same_sparse(G, hl.cat_sparse(*[x[1] for x in b], dims=dims))
        bm, bn = dims
        ref = sp.bmat([[b[i * bn + j][0] for j in range(bn)]
                       for i in range(bm)]).toarray()
        np.testing.assert_array_equal(G.to_scipy().toarray(), ref)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vector_hcat(dtype, S):
    P = Pair(S, dtype)
    xs = [rand_vector(11, dtype, seed=s) for s in (44, 45, 46)]
    pairs = [P.vec(x) for x in xs]
    M = ht.hcat_vectors(*[t for _, t in pairs])
    same_dense(M, hl.hcat_vectors(*[j for j, _ in pairs]))
    assert M.shape == (11, 3)
    same_dense(ht.cat(pairs[0][1], pairs[1][1], dims=2),
               hl.cat(pairs[0][0], pairs[1][0], dims=2))
    # a mismatched partition aligns to the first operand's
    p2 = ht.uniform_partition(11, S)
    bj, bt = P.vec(xs[1], partition=p2)
    same_dense(ht.hcat_vectors(pairs[0][1], bt),
               hl.hcat_vectors(pairs[0][0], bj))
    np.testing.assert_array_equal(M.to_numpy(), np.stack(xs, axis=1))


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_blockdiag_many_and_single(dtype, S):
    P = Pair(S, dtype)
    A, Aj, At = mk(P, 3, 3, 97)
    same_sparse(ht.blockdiag(At), hl.blockdiag(Aj))
    mats = [mk(P, 2 + i, 3 + i, 100 + i) for i in range(5)]
    BD = ht.blockdiag(*[t for _, _, t in mats])
    same_sparse(BD, hl.blockdiag(*[j for _, j, _ in mats]))
    np.testing.assert_array_equal(BD.to_scipy().toarray(),
                                  sp.block_diag([m for m, _, _ in mats])
                                  .toarray())


@pytest.mark.parametrize("S", [1, 4, 8])
def test_cat_with_empty_blocks(S):
    P = Pair(S)
    A = random_sparse(4, 5, 0.4, seed=111)
    Z = sp.csr_matrix((4, 7))
    B = random_sparse(3, 5, 0.4, seed=112)
    C = random_sparse(3, 7, 0.4, seed=113)
    pairs = [P.sparse(sp.csr_matrix(b)) for b in (A, Z, B, C)]
    G = ht.cat_sparse(*[t for _, t in pairs], dims=(2, 2))
    same_sparse(G, hl.cat_sparse(*[j for j, _ in pairs], dims=(2, 2)))
    np.testing.assert_array_equal(G.to_scipy().toarray(),
                                  sp.bmat([[A, Z], [B, C]]).toarray())


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vector_cat_tuple_dims(dtype, S):
    """dims=(n, 1) is vcat, (1, n) hcat to a dense matrix, (1, 1) the
    vector itself (ref blocks.jl:349-383)."""
    P = Pair(S, dtype)
    pairs = [P.vec(rand_vector(7, dtype, seed=120 + i)) for i in range(3)]
    js, ts = [j for j, _ in pairs], [t for _, t in pairs]
    same_vec(ht.cat(*ts, dims=(3, 1)), hl.cat(*js, dims=(3, 1)))
    same_dense(ht.cat(*ts, dims=(1, 3)), hl.cat(*js, dims=(1, 3)))
    assert ht.cat(ts[0], dims=(1, 1)) is ts[0]
    for dims in ((2, 2), (2, 1)):
        with pytest.raises(ValueError):
            ht.cat(*ts, dims=dims)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_three_block_cats(dtype, S):
    P = Pair(S, dtype)
    b = [mk(P, m, 10, 130 + i) for i, m in enumerate((8, 5, 6))]
    V = ht.cat(*[x[2] for x in b], dims=1)
    same_sparse(V, hl.cat(*[x[1] for x in b], dims=1))
    H = ht.cat(*[x[2].transpose_materialized() for x in b], dims=2)
    same_sparse(H, hl.cat(*[x[1].transpose_materialized() for x in b],
                          dims=2))
    np.testing.assert_array_equal(H.to_scipy().toarray(),
                                  sp.vstack([x[0] for x in b]).T.toarray())


@pytest.mark.parametrize("S", [1, 4])
def test_mixed_dtype_promotion(S):
    """An f64 block with an f32 one (and a c128 with an f64) is promoted
    before any scatter: nothing is cut to the first block's dtype."""
    bt = ht.backend_auto(S, device="cpu")
    A = random_sparse(6, 5, 0.4, seed=140)
    B = random_sparse(4, 5, 0.4, seed=141) * (1 + 1e-9)
    A32 = ht.DistSparseMatrix.from_scipy(A, bt, dtype=np.float32)
    B64 = ht.DistSparseMatrix.from_scipy(B, bt, dtype=np.float64)
    V = ht.vcat_sparse(A32, B64)
    assert V.dtype == torch.float64
    np.testing.assert_array_equal(
        V.to_scipy().toarray(),
        sp.vstack([A.astype(np.float32).astype(np.float64), B]).toarray())
    Bc = ht.DistSparseMatrix.from_scipy(B * (1 + 2j), bt)
    assert ht.vcat_sparse(A32, Bc).dtype == torch.complex128
    x32 = ht.DistVector.from_global(rand_vector(5), bt, dtype=np.float32)
    x64 = ht.DistVector.from_global(rand_vector(5, seed=3), bt)
    assert ht.vcat_vectors(x32, x64).dtype == torch.float64
    np.testing.assert_array_equal(ht.vcat_vectors(x32, x64).to_numpy()[5:],
                                  rand_vector(5, seed=3))
    assert ht.hcat_vectors(x32, x64).dtype == torch.float64
    D32 = ht.DistDenseMatrix.from_global(dense_matrix(4, 2), bt,
                                         dtype=np.float32)
    D64 = ht.DistDenseMatrix.from_global(dense_matrix(4, 3, seed=9), bt)
    H = ht.hcat_dense(D32, D64)
    assert H.dtype == torch.float64
    np.testing.assert_array_equal(H.to_numpy()[:, 2:],
                                  dense_matrix(4, 3, seed=9))
