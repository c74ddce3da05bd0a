"""The port's DistDenseMatrix, mesh helpers, dense transpose and dense
repartition against the JAX package's.

The same host arrays, made with numpy from a seed, go through both
packages at S = 1, 2 and 4 shards, in f64 and (where the JAX suite runs
it) c128. The checks:
  * stacked data, partitions and the structural hash equal the JAX
    package's (the padding rows are zero in both);
  * values within rtol 1e-12 of the largest |value| — einsum and XLA sum
    in different orders.
The scenarios are those of tests/test_dense_matrix.py.
"""

import numpy as np
import pytest
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from hpclinalg.parallel import mesh as jmesh
from hpclinalg_torch.parallel import mesh as tmesh
from hpclinalg_torch.partition import shard_mask
from hpclinalg_torch.utils.convert import from_reference

torch.set_num_threads(1)

SHARDS = [1, 2, 4]
DTYPES = [np.float64, np.complex128]
RTOL = 1e-12


def dense(m, n, dtype=np.float64, seed=1):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((m, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        M = M + 1j * rng.standard_normal((m, n))
    return M.astype(dtype)


def vec(n, dtype=np.float64, seed=2):
    return dense(n, 1, dtype, seed)[:, 0]


def backends(S):
    return hl.backend_auto(nshards=S), ht.backend_auto(S, device="cpu")


def both(M, S, dtype=np.float64, row_partition=None):
    """(JAX matrix, port matrix) of host ``M`` on S shards."""
    bj, bt = backends(S)
    p = None if row_partition is None else np.asarray(row_partition)
    return (hl.DistDenseMatrix.from_global(M, bj, row_partition=p, dtype=dtype),
            ht.DistDenseMatrix.from_global(M, bt, row_partition=p, dtype=dtype))


def vecs(x, S, dtype=np.float64, partition=None):
    bj, bt = backends(S)
    p = None if partition is None else np.asarray(partition)
    return (hl.DistVector.from_global(x, bj, partition=p, dtype=dtype),
            ht.DistVector.from_global(x, bt, partition=p, dtype=dtype))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(1.0, float(np.abs(want).max(
                                   initial=0.0))))


def _same(Mt, Mj, ref=None):
    """Port dense matrix ``Mt`` equals JAX matrix ``Mj``: partitions, hash,
    stacked data with zero padding rows (and the host ``ref``)."""
    np.testing.assert_array_equal(Mt.row_partition, Mj.row_partition)
    np.testing.assert_array_equal(Mt.col_partition, Mj.col_partition)
    assert Mt.shape == Mj.shape and Mt.hash == Mj.hash
    data = Mt.data.numpy()
    assert data.shape == tuple(Mj.data.shape)
    _close(data, np.asarray(Mj.data))
    mask = shard_mask(Mt.row_partition, data.shape[1])
    assert np.all(data[~mask] == 0), "padding rows must stay zero"
    if ref is not None:
        _close(Mt.to_numpy(), ref)


def _same_vec(vt, vj, ref):
    np.testing.assert_array_equal(vt.partition, vj.partition)
    _close(vt.data.numpy(), np.asarray(vj.data))
    _close(vt.to_numpy(), ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHARDS)
def test_construction_and_hash(S, dtype):
    M = dense(8, 6, dtype)
    Mj, Mt = both(M, S, dtype)
    _same(Mt, Mj, M)
    assert Mt.hash == ht.dense_structural_hash(Mt.row_partition, 6) \
        == hl.hashing.dense_structural_hash(Mj.row_partition, 6)
    assert Mt.dtype == ht.backend.torch_dtype(dtype)
    cuts = {1: [0, 8], 2: [0, 5, 8], 4: [0, 3, 3, 5, 8]}[S]
    blocks = [M[a:b] for a, b in zip(cuts, cuts[1:])]
    Lj = hl.DistDenseMatrix.from_local(blocks, backends(S)[0])
    Lt = ht.DistDenseMatrix.from_local(blocks, backends(S)[1])
    _same(Lt, Lj, M)
    Zt = ht.DistDenseMatrix.zeros(7, 3, backends(S)[1])
    _same(Zt, hl.DistDenseMatrix.zeros(7, 3, backends(S)[0]), np.zeros((7, 3)))


@pytest.mark.parametrize("S", SHARDS)
def test_from_reference_keeps_hash(S):
    M = dense(11, 5, seed=3)
    Mj, _ = both(M, S)
    Mt = from_reference(backends(S)[1], Mj)
    assert isinstance(Mt, ht.DistDenseMatrix)
    _same(Mt, Mj, M)


@pytest.mark.parametrize("S", SHARDS)
def test_mesh_allgather_scatter(S):
    bj, bt = backends(S)
    p = np.array([0] + [3 * s + 1 for s in range(1, S)] + [3 * S + 2])
    x = vec(int(p[-1]), seed=4)
    xj, xt = vecs(x, S, partition=p)
    full = tmesh.allgather_full(xt.data, p, bt)
    _close(full.numpy(), np.asarray(jmesh.allgather_full(xj.data, p, bj)))
    _close(full.numpy(), x)
    back = tmesh.scatter_from_full(full, p, bt)
    np.testing.assert_array_equal(back.numpy(), xt.data.numpy())
    M = dense(int(p[-1]), 3, seed=5)
    Mj, Mt = both(M, S, row_partition=p)
    blk = tmesh.allgather_full(Mt.data, p, bt)
    _close(blk.numpy(), np.asarray(jmesh.allgather_full(Mj.data, p, bj)))
    np.testing.assert_array_equal(
        tmesh.scatter_from_full(blk, p, bt).numpy(), Mt.data.numpy())
    np.testing.assert_array_equal(tmesh.gather_to_host(Mt.data, p), M)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHARDS)
def test_matvec_rmatvec(S, dtype):
    """Ref :78-140: A x, the repeated product, Aᵀ x without materialising
    and Aᴴ x."""
    M = dense(8, 6, dtype)
    Mj, Mt = both(M, S, dtype)
    for seed in (2, 7):
        x = vec(6, dtype, seed)
        xj, xt = vecs(x, S, dtype)
        _same_vec(Mt @ xt, Mj @ xj, M @ x)
    w = vec(8, dtype, 3)
    wj, wt = vecs(w, S, dtype)
    y = Mt.T @ wt
    assert isinstance(y, ht.DistVector) and len(y) == 6
    _same_vec(y, Mj.T @ wj, M.T @ w)
    _same_vec(Mt.H @ wt, Mj.H @ wj, M.conj().T @ w)
    # an x on another partition is aligned first
    p = np.array([0] * S + [8])
    wj2, wt2 = vecs(w, S, dtype, partition=p)
    _same_vec(Mt.T @ wt2, Mj.T @ wj2, M.T @ w)
    with pytest.raises(ValueError, match="dimension mismatch"):
        Mt @ vecs(vec(5), S)[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHARDS)
def test_square_ops_and_row_vectors(S, dtype):
    """Ref :167-209 and :350-377: vᵀA is a lazy row vector; square A x and
    Aᵀ x share the partition."""
    n = 8
    M = dense(n, n, dtype)
    Mj, Mt = both(M, S, dtype)
    v = vec(n, dtype, 9)
    vj, vt = vecs(v, S, dtype)
    yt = vt.T @ Mt
    assert isinstance(yt, ht.LazyTranspose) and yt.shape == (1, n)
    _same_vec(yt.T, (vj.T @ Mj).T, v @ M)
    zt = vt.T @ Mt.T                                      # vᵀ Mᵀ = (M v)ᵀ
    _same_vec(zt.T, (vj.T @ Mj.T).T, M @ v)
    assert np.array_equal((Mt.T @ vt).partition, (Mt @ vt).partition)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHARDS)
def test_transpose_materialized(S, dtype):
    """Ref :212-250: Aᵀ and Aᴴ as real distributed matrices, rows on A's
    column partition."""
    for m, n in ((8, 6), (13, 3), (3, 13)):
        M = dense(m, n, dtype, seed=m)
        Mj, Mt = both(M, S, dtype)
        _same(Mt.transpose_materialized(), Mj.transpose_materialized(), M.T)
        _same(Mt.T.materialize(), Mj.T.materialize(), M.T)
        _same(Mt.H.materialize(), Mj.H.materialize(), M.conj().T)
        assert Mt.T.T is Mt


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHARDS)
def test_scalar_and_elementwise(S, dtype):
    """Ref :253-303 and the arithmetic cases."""
    cplx = np.issubdtype(np.dtype(dtype), np.complexfloating)
    a = dtype(3.5 + 0.5j) if cplx else dtype(3.5)
    M = dense(14, 9, dtype, seed=61)
    N = dense(14, 9, dtype, seed=62)
    (Mj, Mt), (Nj, Nt) = both(M, S, dtype), both(N, S, dtype)
    for got, want, ref in (
            (a * Mt, a * Mj, a * M), (Mt * a, Mj * a, a * M),
            (Mt + Nt, Mj + Nj, M + N), (Mt - Nt, Mj - Nj, M - N),
            (Mt / 2.0, Mj / 2.0, M / 2), (-Mt, -Mj, -M),
            (Mt + 1.0, Mj + 1.0, M + 1.0), (1.0 - Mt, 1.0 - Mj, 1.0 - M),
            (Mt.conj(), Mj.conj(), np.conj(M)), (Mt.real(), Mj.real(), M.real),
            (Mt.imag(), Mj.imag(), M.imag), (abs(Mt), abs(Mj), np.abs(M))):
        _same(got, want, ref)
    for Ct, ref in ((a * Mt.T, (a * M).T), (Mt.T * a, (a * M).T)):
        assert isinstance(Ct, ht.LazyTranspose)
        _close(Ct.materialize().to_numpy(), ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHARDS)
def test_norms_and_reductions(S, dtype):
    """Ref :306-347 and the reduction cases."""
    M = dense(12, 7, dtype, seed=67)
    Mj, Mt = both(M, S, dtype)
    for p in (2, 1, np.inf, 3):
        _close(float(Mt.norm(p)), float(Mj.norm(p)))
    _close(float(Mt.norm()), np.linalg.norm(M))
    for p, ref in ((1, np.abs(M).sum(axis=0).max()),
                   (np.inf, np.abs(M).sum(axis=1).max())):
        _close(float(Mt.opnorm(p)), float(Mj.opnorm(p)))
        _close(float(Mt.opnorm(p)), ref)
    _close(Mt.sum().numpy(), M.sum())
    _close(Mt.sum(axis=0).numpy(), np.asarray(Mj.sum(axis=0)))
    _same_vec(Mt.sum(axis=1), Mj.sum(axis=1), M.sum(axis=1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", SHARDS)
def test_matmat(S, dtype):
    """Dense × dense across non-square shapes, and Aᵀ B (ref
    dense.jl:952-982)."""
    for (m, k, n) in [(13, 17, 8), (5, 3, 9), (1, 7, 1)]:
        M = dense(m, k, dtype, seed=m)
        N = dense(k, n, dtype, seed=n)
        (Mj, Mt), (Nj, Nt) = both(M, S, dtype), both(N, S, dtype)
        _same(Mt @ Nt, Mj @ Nj, M @ N)
    M = dense(15, 10, dtype, seed=65)
    N = dense(15, 6, dtype, seed=66)
    (Mj, Mt), (Nj, Nt) = both(M, S, dtype), both(N, S, dtype)
    _same(Mt.T @ Nt, Mj.T @ Nj, M.T @ N)
    _same(Nt.T @ Mt, Nj.T @ Mj, N.T @ M)
    # Aᵀ Bᵀ = (B A)ᵀ stays lazy; A Bᵀ materialises
    P = dense(6, 15, dtype, seed=68)
    Pj, Pt = both(P, S, dtype)
    L = Mt.T @ Pt.T
    assert isinstance(L, ht.LazyTranspose)
    _close(L.to_numpy(), M.T @ P.T)
    _same(Pt @ Nt.T.T, Pj @ Nj, P @ N)
    _same(Pt @ Mt @ Mt.T @ Nt, Pj @ Mj @ Mj.T @ Nj, P @ M @ M.T @ N)
    with pytest.raises(ValueError, match="dimension mismatch"):
        Mt @ Mt


@pytest.mark.parametrize("S", SHARDS)
def test_repartition_dense(S):
    """Ref: DenseRepartitionPlan (dense.jl:1571-1761), onto uneven
    partitions with empty shards; addition aligns a mismatched operand."""
    M = dense(17, 5, seed=70)
    Mj, Mt = both(M, S)
    cuts = [np.array([0] + [17] * S), np.array([0] * S + [17]),
            np.concatenate([[0], np.linspace(2, 15, S - 1).astype(int), [17]])]
    for p in cuts:
        _same(Mt.repartition(p), Mj.repartition(p), M)
        _same(ht.repartition(Mt, p), Mj.repartition(p), M)
    assert Mt.repartition(Mt.row_partition) is Mt
    Nj, Nt = both(M, S, row_partition=cuts[1])
    _same(Mt + Nt, Mj + Nj, 2 * M)
    with pytest.raises(ValueError):
        Mt.repartition(np.array([0, 17]) if S > 1 else np.array([0, 8, 17]))


def test_later_slices_raise():
    """Indexing, index assignment and mapslices work (dense_index, setindex
    and map_rows); what the JAX package rejects still raises: a scalar
    index and an axis past 1."""
    M = dense(6, 4)
    Mt = ht.DistDenseMatrix.from_global(M, ht.backend_auto(2, device="cpu"))
    np.testing.assert_array_equal(Mt[1:3, 0:2].to_numpy(), M[1:3, 0:2])
    np.testing.assert_array_equal(Mt.mapslices(lambda r: r, axis=1)
                                  .to_numpy(), M)
    Mt[0:1, 0:1] = 1.0
    M[0, 0] = 1.0
    np.testing.assert_array_equal(Mt.to_numpy(), M)
    with pytest.raises(TypeError):
        Mt[1, 2]
    with pytest.raises(ValueError):
        Mt.mapslices(lambda r: r, axis=2)
