"""Public API the JAX package has and the port lacked until now, held
against the JAX package on the same seeded inputs:
``Factorization.solve_transpose``; ``backend_auto``'s parameters and
``Backend.with_dtype``; ``DistSparseMatrix.row_partition_hash`` and
``from_structure``, ``SparseStructure.local_sizes``,
``DistDenseMatrix.to_numpy_ro`` and ``ops.spmv.get_vector_plan``. Their
process-group forms are in ``tests/test_torch_dist.py`` (the transposed
solve, ``with_dtype``) and ``tests/test_torch_dist_algebra.py``
(``from_structure``)."""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg.ops.spmv as jspmv
import hpclinalg_torch as ht
import hpclinalg_torch.ops.spmv as tspmv
from hpclinalg_torch.tools.matrices import laplace2d

torch.set_num_threads(1)

SHARDS = (1, 4)
PARTITION = {1: None, 4: np.array([0, 30, 30, 70, 100])}


def unsymmetric(k=10, seed=11):
    L = laplace2d(k)
    L.data = L.data * (1.0 + 0.2 * np.random.default_rng(seed).random(L.nnz))
    return L


def both(M, S):
    p = PARTITION[S]
    return (ht.DistSparseMatrix.from_scipy(M, ht.backend_auto(S, device="cpu"),
                                           row_partition=p),
            hl.DistSparseMatrix.from_scipy(M, hl.backend_auto(nshards=S),
                                           row_partition=p))


@pytest.mark.parametrize("S", SHARDS)
def test_solve_transpose_against_jax(S):
    M = unsymmetric()
    bh = np.random.default_rng(12).standard_normal(M.shape[0])
    At, Aj = both(M, S)
    bt = ht.DistVector.from_global(bh, At.backend)
    bj = hl.DistVector.from_global(bh, Aj.backend)
    got = ht.lu(At).solve_transpose(bt).to_numpy()
    want = hl.lu(Aj).solve_transpose(bj).to_numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(M.T @ got, bh, rtol=1e-10, atol=1e-10)
    # a host right-hand side, and refine= passed through
    np.testing.assert_allclose(ht.lu(At).solve_transpose(bh, refine=2), want,
                               rtol=1e-10, atol=1e-12)


def test_backend_auto_takes_the_jax_parameters():
    names = list(inspect.signature(ht.backend_auto).parameters)
    jnames = list(inspect.signature(hl.backend_auto).parameters)
    # the port's ``device`` stands where the JAX package has ``platform``
    assert names == [("device" if n == "platform" else n) for n in jnames]
    assert inspect.signature(ht.backend_auto).parameters["nshards"] \
        .default is None


def test_backend_auto_none_is_one_stacked_shard():
    be = ht.backend_auto(None, device="cpu")
    assert be.nshards == 1 and not be.is_dist
    assert ht.backend_auto(device="cpu") == be


def test_backend_auto_fourth_positional_is_the_solver():
    be = ht.backend_auto(2, np.float32, np.int64, "device", device="cpu")
    jbe = hl.backend_auto(2, np.float32, np.int64, "device")
    assert (be.nshards, be.dtype, be.index_dtype, be.solver) \
        == (jbe.nshards, np.dtype(jbe.dtype), np.dtype(jbe.index_dtype),
            jbe.solver)


@pytest.mark.parametrize("dtype", (np.float32, np.complex128))
def test_with_dtype_against_jax(dtype):
    be = ht.backend_auto(4, solver="device", device="cpu")
    jbe = hl.backend_auto(4, solver="device")
    got, want = be.with_dtype(dtype), jbe.with_dtype(dtype)
    assert got.dtype == np.dtype(want.dtype) == np.dtype(dtype)
    assert (got.nshards, got.solver, got.device, got.group) \
        == (4, "device", be.device, None)
    assert be.dtype == np.float64          # a new backend, not a mutation
    x = np.random.default_rng(13).standard_normal(37)
    np.testing.assert_array_equal(
        ht.DistVector.from_global(x, got).data.numpy(),
        np.asarray(hl.DistVector.from_global(x, want).data))


@pytest.mark.parametrize("S", SHARDS)
def test_sparse_partition_hash_and_local_sizes_against_jax(S):
    At, Aj = both(unsymmetric(), S)
    assert At.row_partition_hash == Aj.row_partition_hash
    np.testing.assert_array_equal(At.structure.local_sizes(),
                                  Aj.structure.local_sizes())
    assert At.row_partition_hash == ht.partition_hash(At.row_partition)


@pytest.mark.parametrize("S", SHARDS)
def test_from_structure_against_jax(S):
    M = unsymmetric()
    At, Aj = both(M, S)
    p = At.row_partition
    parts = [3.0 * M[p[s]: p[s + 1]].data for s in range(S)]
    Bt = ht.DistSparseMatrix.from_structure(At.structure, parts)
    Bj = hl.DistSparseMatrix.from_structure(Aj.structure, parts)
    assert Bt.structure is At.structure and Bt.hash == Bj.hash
    np.testing.assert_array_equal(Bt.nzval.numpy(), np.asarray(Bj.nzval))
    Ct = ht.DistSparseMatrix.from_structure(At.structure, parts,
                                            dtype=np.float32)
    assert Ct.dtype == torch.float32
    np.testing.assert_array_equal(Ct.to_scipy().toarray(),
                                  (3.0 * M).astype(np.float32).toarray())


@pytest.mark.parametrize("S", SHARDS)
def test_dense_to_numpy_ro_against_jax(S):
    Y = np.random.default_rng(14).standard_normal((100, 3))
    Dt = ht.DistDenseMatrix.from_global(Y, ht.backend_auto(S, device="cpu"),
                                        row_partition=PARTITION[S])
    Dj = hl.DistDenseMatrix.from_global(Y, hl.backend_auto(nshards=S),
                                        row_partition=PARTITION[S])
    np.testing.assert_array_equal(Dt.to_numpy_ro(), Dj.to_numpy_ro())
    np.testing.assert_array_equal(Dt.to_numpy_ro(), Y)


@pytest.mark.parametrize("S", SHARDS)
def test_get_vector_plan_against_jax(S):
    M = (sp.random(100, 100, 0.05, format="csr",
                   random_state=np.random.default_rng(15))
         + sp.eye(100)).tocsr()
    At, Aj = both(M, S)
    xh = np.random.default_rng(16).standard_normal(100)
    xt = ht.DistVector.from_global(xh, At.backend)
    xj = hl.DistVector.from_global(xh, Aj.backend)
    pt, pj = tspmv.get_vector_plan(At, xt), jspmv.get_vector_plan(Aj, xj)
    assert pt is tspmv.get_spmv_plan(At, xt).exchange
    np.testing.assert_array_equal(pt.counts, pj.counts)
    assert (pt.out_pad, pt.is_identity) == (pj.out_pad, pj.is_identity)
    np.testing.assert_array_equal(pt.apply(xt.data).numpy(),
                                  np.asarray(pj.apply(xj.data)))
