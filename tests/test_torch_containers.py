"""The port's DistVector and DistSparseMatrix against the JAX package's.

Vector arithmetic is elementwise, so results must match the JAX package to
the last bit in f64 except reductions, whose summation order differs (rtol
1e-13). Structure arrays are host numpy and must be equal."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht

torch.set_num_threads(1)

SHARDS = [1, 4, 8]


def _pair(x, S, partition=None):
    jv = hl.DistVector.from_global(x, hl.backend_auto(nshards=S),
                                   partition=partition)
    tv = ht.DistVector.from_global(x, ht.backend_auto(S, device="cpu"),
                                   partition=partition)
    return jv, tv


def _same_stack(tv, jv):
    assert np.array_equal(tv.partition, jv.partition)
    np.testing.assert_array_equal(tv.data.numpy(), np.asarray(jv.data))


@pytest.mark.parametrize("S", SHARDS)
def test_vector_layout_and_roundtrip(S):
    x = np.random.default_rng(S).standard_normal(37)
    jv, tv = _pair(x, S)
    _same_stack(tv, jv)
    np.testing.assert_array_equal(tv.to_numpy(), x)
    z = ht.DistVector.zeros(37, ht.backend_auto(S, device="cpu"))
    _same_stack(z, hl.DistVector.zeros(37, hl.backend_auto(nshards=S)))
    assert len(tv) == 37 and tv.shape == (37,) and tv.dtype == torch.float64


@pytest.mark.parametrize("S", SHARDS)
def test_vector_arithmetic(S):
    rng = np.random.default_rng(10 + S)
    a, b = rng.standard_normal(45), rng.standard_normal(45)
    ja, ta = _pair(a, S)
    jb, tb = _pair(b, S)
    for jr, tr in [(ja + jb, ta + tb), (ja - jb, ta - tb), (ja * jb, ta * tb),
                   (ja * 2.5, ta * 2.5), (2.5 * ja, 2.5 * ta),
                   (ja + 1.0, ta + 1.0), (ja - 1.0, ta - 1.0),
                   (1.0 - ja, 1.0 - ta), (-ja, -ta)]:
        _same_stack(tr, jr)   # padding stays zero in both
    # a tensor scalar (a CG step length) must keep the padding zero too
    alpha = torch.tensor(float("inf"), dtype=torch.float64)
    out = (ta * alpha).data.numpy()
    mask = ta.mask().numpy()
    assert np.all(out[~mask] == 0) and np.all(np.isinf(out[mask] + 0 * a[0]))
    np.testing.assert_allclose(float(ta.dot(tb)), float(ja.dot(jb)),
                               rtol=1e-13)
    for p in (1, 2, np.inf):
        np.testing.assert_allclose(float(ta.norm(p)), float(ja.norm(p)),
                                   rtol=1e-13)


def test_vector_complex_dot():
    rng = np.random.default_rng(3)
    a = rng.standard_normal(20) + 1j * rng.standard_normal(20)
    b = rng.standard_normal(20) + 1j * rng.standard_normal(20)
    be = ht.backend_auto(4, device="cpu")
    ta, tb = ht.DistVector.from_global(a, be), ht.DistVector.from_global(b, be)
    np.testing.assert_allclose(complex(ta.dot(tb)), np.vdot(a, b), rtol=1e-13)


def test_vector_deferred_leaves_caller_array_writable():
    x = np.arange(10.0)
    be = ht.backend_auto(4, device="cpu")
    v = ht.DistVector.from_global_deferred(x, be)
    assert x.flags.writeable
    x[0] = 99.0  # the vector holds its own copy
    assert v.to_numpy()[0] == 0.0
    assert v._data is None  # host consumers never materialise the tensor
    np.testing.assert_array_equal(v.data.numpy(),
                                  ht.DistVector.from_global(np.arange(10.0), be)
                                  .data.numpy())


def test_vector_mismatch_errors():
    be = ht.backend_auto(2, device="cpu")
    a = ht.DistVector.from_global(np.ones(10), be)
    b = ht.DistVector.from_global(np.ones(10), be, partition=[0, 3, 10])
    c = a + b   # a mismatched partition is aligned, not an error
    assert np.array_equal(c.partition, a.partition)
    np.testing.assert_array_equal(c.to_numpy(), np.full(10, 2.0))
    with pytest.raises(ValueError):
        a + ht.DistVector.from_global(np.ones(10), ht.backend_auto(
            5, device="cpu"))


def _matrices():
    rng = np.random.default_rng(5)
    k = 9
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    lap = (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k))).tocsr()
    R = sp.random(60, 75, 0.06, format="csr", random_state=rng)
    E = sp.csr_matrix((30, 30))
    return [("laplace", lap), ("rect", R), ("empty", E)]


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,A", _matrices(), ids=[m[0] for m in _matrices()])
def test_sparse_structure_matches(S, name, A):
    Aj = hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(nshards=S))
    At = ht.DistSparseMatrix.from_scipy(A, ht.backend_auto(S, device="cpu"))
    sj, st = Aj.structure, At.structure
    for a in ("row_partition", "col_partition", "nnz_local"):
        assert np.array_equal(getattr(st, a), getattr(sj, a)), a
    for a in ("indptr", "col_indices", "colval"):
        for s in range(S):
            assert np.array_equal(getattr(st, a)[s], getattr(sj, a)[s]), a
    for a in ("nnz", "Lrow", "NNZpad", "Gmax", "Gpad"):
        assert getattr(st, a) == getattr(sj, a), a
    np.testing.assert_array_equal(st.row_ids_dev.numpy(),
                                  np.asarray(sj.row_ids_dev))
    np.testing.assert_array_equal(st.colval_dev.numpy(),
                                  np.asarray(sj.colval_dev))
    np.testing.assert_array_equal(At.nzval.numpy(), np.asarray(Aj.nzval))
    assert At.hash == Aj.hash and At.shape == Aj.shape


@pytest.mark.parametrize("S", SHARDS)
def test_sparse_roundtrip_and_values(S):
    rng = np.random.default_rng(6)
    A = sp.random(50, 50, 0.1, format="csr", random_state=rng)
    be = ht.backend_auto(S, device="cpu")
    At = ht.DistSparseMatrix.from_scipy(A, be)
    B = At.to_scipy()
    assert (B != A).nnz == 0
    assert At.nnz() == A.nnz
    At2 = At.with_values(At.nzval * 3.0)
    assert At2.structure is At.structure and At2.hash == At.hash
    assert abs(At2.to_scipy() - 3.0 * A).max() < 1e-15
    pat = At.pattern_csr()
    assert (pat != (A != 0).astype(np.float32)).nnz == 0
    Af = ht.DistSparseMatrix.from_scipy(A, be, dtype=np.float32)
    assert Af.dtype == torch.float32


def test_issymmetric():
    be = ht.backend_auto(4, device="cpu")
    A = sp.random(30, 30, 0.1, format="csr", random_state=1)
    assert ht.DistSparseMatrix.from_scipy(A + A.T, be).issymmetric()
    assert not ht.DistSparseMatrix.from_scipy(A + 2 * A.T, be).issymmetric()
    assert not ht.DistSparseMatrix.from_scipy(sp.random(
        3, 4, 0.5, format="csr", random_state=2), be).issymmetric()
