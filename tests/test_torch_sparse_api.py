"""The port's DistSparseMatrix value maps and adjoint against the JAX
package's (tests/test_sparse_api.py:36-42, 138, 313-328), and
``ht.repartition_dense`` against ``hl.repartition_dense``.

Both packages get the same seeded scipy input; values must agree to rtol
1e-12, and the port's nzval padding must stay exactly zero.
"""

import numpy as np
import pytest
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from utils import dense_matrix, rand_vector, random_sparse

torch.set_num_threads(1)

RTOL = 1e-12
CONFIGS = [(np.float64, 1), (np.float64, 4), (np.complex128, 4),
           (np.float64, 8)]
IDS = ["f64-serial", "f64-4shards", "c128-4shards", "f64-8shards"]


def _pair(A, S, dtype):
    Aj = hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(nshards=S,
                                                           dtype=dtype),
                                        dtype=dtype)
    At = ht.DistSparseMatrix.from_scipy(A, ht.backend_auto(S, dtype=dtype,
                                                           device="cpu"),
                                        dtype=dtype)
    return Aj, At


def _same(Mt, Mj):
    """Same pattern and hash, values to RTOL, padding slots zero."""
    assert Mt.hash == Mj.hash
    st = Mt.structure
    nz = Mt.nzval.numpy()
    for s in range(nz.shape[0]):
        assert np.all(nz[s, st.nnz_local[s]:] == 0), "nzval padding not zero"
    np.testing.assert_allclose(Mt.to_scipy().toarray(),
                               Mj.to_scipy().toarray(), rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_sparse_value_maps(dtype, S):
    A = random_sparse(15, 15, 0.3, dtype, seed=53)
    A.data = A.data * 5
    Aj, At = _pair(A, S, dtype)
    pairs = [(abs(At), abs(Aj)), (At.abs(), Aj.abs()), (At.conj(), Aj.conj()),
             (At.real(), Aj.real()), (At.imag(), Aj.imag()),
             (At.abs2(), Aj.abs2()), (At * 3.0, Aj * 3.0),
             (At / 2.0, Aj / 2.0), (-At, -Aj),
             (At.map_nonzeros(lambda v: v ** 2),
              Aj.map_nonzeros(lambda v: v ** 2))]
    if dtype == np.float64:
        pairs += [(At.floor(), Aj.floor()), (At.ceil(), Aj.ceil()),
                  (At.round(), Aj.round())]
    for t, j in pairs:
        _same(t, j)
    assert At.abs2().dtype == torch.float64


@pytest.mark.parametrize("S", [1, 4, 8])
def test_sparse_map_nonzeros_rezeroes_padding(S):
    """v + 1 does not keep zeros: the padding slots are masked back to zero
    (JAX sparse.py:386-394); a map said to keep zeros is not masked."""
    import jax.numpy as jnp

    A = random_sparse(17, 13, 0.3, np.float64, seed=61)
    Aj, At = _pair(A, S, np.float64)
    _same(At.map_nonzeros(lambda v: v + 1.0, zero_preserving=False),
          Aj.map_nonzeros(lambda v: v + 1.0, zero_preserving=False))
    _same(At.map_nonzeros(torch.exp, zero_preserving=False),
          Aj.map_nonzeros(jnp.exp, zero_preserving=False))
    st = At.structure
    pad = np.arange(st.NNZpad)[None, :] >= st.nnz_local[:, None]
    assert pad.any()
    raw = At.map_nonzeros(lambda v: v + 1.0).nzval.numpy()
    assert np.all(raw[pad] == 1.0)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_sparse_adjoint(dtype, S):
    """A.H is the lazy conjugate transpose: materialised and applied to a
    vector (tests/test_sparse_api.py:313-325)."""
    A = random_sparse(12, 17, 0.3, dtype, seed=159)
    Aj, At = _pair(A, S, dtype)
    assert isinstance(At.H, ht.LazyTranspose)
    _same(At.H.materialize(), Aj.H.materialize())
    x = rand_vector(12, dtype, seed=160)
    xj = hl.DistVector.from_global(x, Aj.backend, dtype=dtype)
    xt = ht.DistVector.from_global(x, At.backend, dtype=dtype)
    np.testing.assert_allclose((At.H @ xt).to_numpy(),
                               np.asarray((Aj.H @ xj).to_numpy()), rtol=RTOL)
    np.testing.assert_allclose((At.H @ xt).to_numpy(), A.toarray().conj().T @ x,
                               rtol=1e-10)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_repartition_dense_exported(S):
    M = dense_matrix(17, 5, seed=70)
    p = np.array([0] * S + [17])
    Mt = ht.DistDenseMatrix.from_global(M, ht.backend_auto(S, device="cpu"))
    Mj = hl.DistDenseMatrix.from_global(M, hl.backend_auto(nshards=S))
    Rt, Rj = ht.repartition_dense(Mt, p), hl.repartition_dense(Mj, p)
    assert np.array_equal(Rt.row_partition, Rj.row_partition)
    np.testing.assert_array_equal(Rt.data.numpy(), np.asarray(Rj.data))
