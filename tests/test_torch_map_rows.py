"""The port's map_rows, vertex_indices and mapslices against the JAX
package's: the 13 scenarios of tests/test_map_rows.py, each function
written once in jax.numpy and once in torch, on the same seeded inputs
(rtol 1e-12), f64 at S = 1, 4 and 8 and c128 at S = 4, the inputs on a
partition with an empty shard when S > 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from test_torch_indexing import CONFIGS, IDS, Pair, parted

torch.set_num_threads(1)

RTOL = 1e-12
F64 = [(np.float64, 1), (np.float64, 4), (np.float64, 8)]


def agree(rt, rj, ref):
    assert type(rt).__name__ == type(rj).__name__
    part = rt.partition if hasattr(rt, "partition") else rt.row_partition
    partj = rj.partition if hasattr(rj, "partition") else rj.row_partition
    assert np.array_equal(part, partj)
    got = rt.to_numpy()
    np.testing.assert_allclose(got, np.asarray(rj.to_numpy()), rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-14)
    data = rt.data.numpy()
    m = ht.partition.shard_mask(part, data.shape[1])
    assert np.all(data[~m] == 0), "padding not zero"


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vector_to_scalar(dtype, S):
    x = np.arange(1.0, 9.0).astype(dtype)
    vj, vt = Pair(S, dtype).vec(x)
    agree(ht.map_rows(lambda a: a ** 2 + 1, vt),
          hl.map_rows(lambda a: a ** 2 + 1, vj), x ** 2 + 1)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_two_vectors_to_scalar(dtype, S):
    P = Pair(S, dtype)
    uj, ut = P.vec(np.array([1, 2, 3, 4], dtype))
    vj, vt = P.vec(np.array([4, 3, 2, 1], dtype))
    agree(ht.map_rows(lambda a, b: a * b, ut, vt),
          hl.map_rows(lambda a, b: a * b, uj, vj), np.array([4, 6, 6, 4]))


@pytest.mark.parametrize("dtype,S", F64)
def test_matrix_row_norms(dtype, S):
    M = np.array([[1.0, 0, 0], [0, 2, 0], [0, 0, 3], [1, 1, 1]])
    Mj, Mt = Pair(S, dtype).dense(M)
    agree(ht.map_rows(lambda r: torch.linalg.norm(r), Mt),
          hl.map_rows(lambda r: jnp.linalg.norm(r), Mj),
          np.array([1, 2, 3, np.sqrt(3.0)]))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_constant_row_to_matrix(S):
    M = np.array([[1.0, 2], [3, 4], [5, 6]])
    Mj, Mt = Pair(S).dense(M)
    ct = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    cj = jnp.array([1.0, 2.0, 3.0])
    rt = ht.map_rows(lambda r: ct, Mt, out_dtype=np.float64)
    assert rt.shape == (3, 3)
    agree(rt, hl.map_rows(lambda r: cj, Mj, out_dtype=np.float64),
          np.tile([1.0, 2, 3], (3, 1)))


@pytest.mark.parametrize("dtype,S", F64)
def test_sum_prod_rows(dtype, S):
    M = np.array([[1.0, 2], [3, 4], [5, 6], [7, 8]])
    Mj, Mt = Pair(S, dtype).dense(M)
    rt = ht.map_rows(lambda r: torch.stack([r.sum(), r.prod()]), Mt)
    assert rt.shape == (4, 2)
    agree(rt, hl.map_rows(lambda r: jnp.stack([jnp.sum(r), jnp.prod(r)]), Mj),
          np.array([[3.0, 2], [7, 12], [11, 30], [15, 56]]))


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_matrix_plus_vector_weighted(dtype, S):
    P = Pair(S, dtype)
    M = np.arange(1.0, 13.0).reshape(4, 3).astype(dtype)
    w = np.array([1.0, 2, 3, 4], dtype)
    (Mj, Mt), (wj, wt) = P.dense(M), P.vec(w)
    agree(ht.map_rows(lambda r, wi: r.sum() * wi, Mt, wt),
          hl.map_rows(lambda r, wi: jnp.sum(r) * wi, Mj, wj), M.sum(1) * w)


@pytest.mark.parametrize("dtype,S", F64)
def test_two_matrices_row_dot(dtype, S):
    P = Pair(S, dtype)
    (Aj, At) = P.dense(np.array([[1.0, 2], [3, 4]]))
    (Bj, Bt) = P.dense(np.array([[10.0, 20], [30, 40]]))
    agree(ht.map_rows(lambda a, b: torch.dot(a, b), At, Bt),
          hl.map_rows(lambda a, b: jnp.dot(a, b), Aj, Bj),
          np.array([50.0, 250.0]))


@pytest.mark.parametrize("S", [4, 8])
def test_mismatched_partitions_align(S):
    """The result lies on the first argument's partition."""
    P = Pair(S)
    x = np.arange(1.0, 7.0)
    uj, ut = P.vec(x, partition=ht.uniform_partition(6, S))
    vj, vt = P.vec(10.0 * x, partition=parted(6, S))
    rt = ht.map_rows(lambda a, b: a + b, ut, vt)
    agree(rt, hl.map_rows(lambda a, b: a + b, uj, vj), 11.0 * x)
    assert np.array_equal(rt.partition, ut.partition)


def test_complex_abs2_and_parts():
    P = Pair(4, np.complex128)
    z = np.array([1 + 2j, 3 + 4j, 5 + 6j, 7 + 8j])
    zj, zt = P.vec(z)
    agree(ht.map_rows(lambda x: (x * torch.conj(x)).real, zt,
                      out_dtype=np.float64),
          hl.map_rows(lambda x: (x * jnp.conj(x)).real, zj,
                      out_dtype=np.float64), np.abs(z) ** 2)
    Mj, Mt = P.dense(np.array([[1 + 1j, 2 - 1j], [3 + 2j, 4 - 2j]]))
    rt = ht.map_rows(lambda r: torch.stack([r[0].real, r[1].imag]), Mt,
                     out_dtype=np.float64)
    assert rt.dtype == torch.float64
    agree(rt, hl.map_rows(lambda r: jnp.stack([r[0].real, r[1].imag]), Mj,
                          out_dtype=np.float64),
          np.array([[1.0, -1], [3, -2]]))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_identity_row_transform(S):
    M = np.array([[1.0, 2, 3], [4, 5, 6]])
    Mj, Mt = Pair(S).dense(M)
    agree(ht.map_rows(lambda r: r, Mt), hl.map_rows(lambda r: r, Mj), M)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_row_max(S):
    M = np.array([[1.0, 5, 3], [7, 2, 4], [3, 3, 9]])
    Mj, Mt = Pair(S).dense(M)
    agree(ht.map_rows(torch.max, Mt), hl.map_rows(jnp.max, Mj),
          np.array([5.0, 7, 9]))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_vertex_indices(S):
    P = Pair(S)
    p = parted(7, S)
    vt, vj = ht.vertex_indices(p, P.bt), hl.vertex_indices(p, P.bj)
    assert vt.dtype == torch.int64
    np.testing.assert_array_equal(vt.to_numpy(), np.asarray(vj.to_numpy()))
    assert np.array_equal(vt.partition, p)
    xj, xt = P.vec(np.full(7, 2.0), partition=p)
    agree(ht.map_rows(lambda i, x: i.to(torch.float64) * x, vt, xt),
          hl.map_rows(lambda i, x: i.astype(jnp.float64) * x, vj, xj),
          2.0 * np.arange(7))


def test_map_rows_type_errors():
    with pytest.raises(TypeError):
        ht.map_rows(lambda a: a, np.ones(4))
    vt = Pair(4).vec(np.ones(4))[1]
    with pytest.raises(TypeError):
        ht.map_rows(lambda a, b: a + b, vt, np.ones(4))


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_mapslices(dtype, S):
    """mapslices over rows (map_rows) and over columns (gathered whole)."""
    rng = np.random.default_rng(11)
    M = rng.standard_normal((9, 4)).astype(dtype)
    Mj, Mt = Pair(S, dtype).dense(M)
    agree(Mt.mapslices(lambda r: r.sum() * 2),
          Mj.mapslices(lambda r: jnp.sum(r) * 2), M.sum(1) * 2)
    rt = Mt.mapslices(lambda c: torch.stack([c.sum(), (c * c).sum()]),
                      axis=0)
    rj = Mj.mapslices(lambda c: jnp.stack([jnp.sum(c), jnp.sum(c * c)]),
                      axis=0)
    agree(rt, rj, np.stack([M.sum(0), (M * M).sum(0)]))
    agree(Mt.mapslices(lambda c: c[1:3] * 3, axis=0),
          Mj.mapslices(lambda c: c[1:3] * 3, axis=0), M[1:3] * 3)
    with pytest.raises(ValueError):
        Mt.mapslices(lambda c: c, axis=2)
