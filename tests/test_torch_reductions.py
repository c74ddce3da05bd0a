"""The port's sparse reductions against the JAX package's
(tests/test_sparse_api.py:24-27, 48-59, 310): norm, opnorm(1 | inf),
sum(axis = None | 0 | 1), tr, maximum, minimum and mean, on the same
seeded input, rtol 1e-12, f64 at S = 1, 4 and 8 and c128 at S = 4, each on
a row partition with an empty shard when S > 1.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
from test_torch_indexing import CONFIGS, IDS, Pair
from utils import random_sparse

torch.set_num_threads(1)

RTOL = 1e-12


def close(t, j, ref=None):
    t = np.asarray(t.to_numpy() if hasattr(t, "to_numpy") else t)
    j = np.asarray(j.to_numpy() if hasattr(j, "to_numpy") else j)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=0)
    if ref is not None:
        np.testing.assert_allclose(t, ref, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_norms(dtype, S):
    A = random_sparse(18, 18, 0.25, dtype, seed=52)
    Aj, At = Pair(S, dtype).sparse(A)
    D = A.toarray()
    close(At.norm(), Aj.norm(), sp.linalg.norm(A))
    close(At.norm(1), Aj.norm(1), np.abs(D).sum())
    close(At.opnorm(np.inf), Aj.opnorm(np.inf), np.abs(D).sum(axis=1).max())
    close(At.opnorm(1), Aj.opnorm(1), np.abs(D).sum(axis=0).max())
    with pytest.raises(ValueError):
        At.opnorm(2)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_sum_dims(dtype, S):
    A = random_sparse(17, 23, 0.25, dtype, seed=54)
    Aj, At = Pair(S, dtype).sparse(A)
    close(At.sum(), Aj.sum(), A.sum())
    r, c = At.sum(axis=1), At.sum(axis=0)
    assert np.array_equal(r.partition, At.row_partition)
    assert np.array_equal(c.partition, At.col_partition)
    close(r, Aj.sum(axis=1), np.asarray(A.sum(axis=1)).ravel())
    close(c, Aj.sum(axis=0), np.asarray(A.sum(axis=0)).ravel())
    with pytest.raises(ValueError):
        At.sum(axis=2)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_trace(dtype, S):
    A = random_sparse(21, 21, 0.3, dtype, seed=55) + sp.eye(21, dtype=dtype)
    Aj, At = Pair(S, dtype).sparse(sp.csr_matrix(A))
    close(At.tr(), Aj.tr(), A.diagonal().sum())


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_maximum_minimum_mean(dtype, S):
    """maximum and minimum count the implicit zeros of a pattern that is
    not full, and only then; mean divides by m*n."""
    P = Pair(S, dtype)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = random_sparse(14, 19, 0.3, np.float64, seed=158).astype(dtype)
    else:
        A = random_sparse(14, 19, 0.3, dtype, seed=158)
    Aj, At = P.sparse(A)
    D = A.toarray()
    close(At.mean(), Aj.mean(), D.mean())
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        return
    close(At.maximum(), Aj.maximum(), D.max())
    close(At.minimum(), Aj.minimum(), D.min())
    Pos = sp.csr_matrix(np.abs(D) + (D != 0))
    Pj, Pt = P.sparse(Pos)
    close(Pt.minimum(), Pj.minimum(), 0.0)
    F = sp.csr_matrix(np.abs(D) + 1.0)
    Fj, Ft = P.sparse(F)
    close(Ft.minimum(), Fj.minimum(), (np.abs(D) + 1.0).min())
    # a full matrix of negative entries must not report 0 as its maximum
    N = sp.csr_matrix(-(np.abs(D) + 1.0))
    Nj, Nt = P.sparse(N)
    close(Nt.maximum(), Nj.maximum(), -1.0 - np.abs(D).min())
    assert float(Nt.maximum()) < 0


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_norm_p_and_opnorm_nonsquare(dtype, S):
    A = random_sparse(9, 22, 0.35, dtype, seed=162)
    Aj, At = Pair(S, dtype).sparse(A)
    D = A.toarray()
    close(At.norm(3), Aj.norm(3), (np.abs(D) ** 3).sum() ** (1 / 3))
    close(At.norm(np.inf), Aj.norm(np.inf), np.abs(D).max())
    close(At.opnorm(1), Aj.opnorm(1), np.abs(D).sum(axis=0).max())
    close(At.opnorm(np.inf), Aj.opnorm(np.inf), np.abs(D).sum(axis=1).max())


@pytest.mark.parametrize("S", [1, 4, 8])
def test_segment_sums_keep_padding_apart(S):
    """Row and column sums on a matrix whose shards hold very different
    counts of entries (most nzval slots of the light shards are padding):
    each padding slot has an index_add_ slot of its own, so nothing lands
    on another shard's rows."""
    rng = np.random.default_rng(7)
    n = 64
    D = np.zeros((n, n))
    D[-8:, :] = rng.standard_normal((8, n))      # dense last rows
    D[np.arange(n - 8), np.arange(n - 8)] = 1.0 + np.arange(n - 8)
    A = sp.csr_matrix(D)
    Aj, At = Pair(S).sparse(A)
    if S > 1:
        assert At.structure.NNZpad > At.structure.nnz_local.min() + 8
    close(At.sum(axis=1), Aj.sum(axis=1), D.sum(axis=1))
    close(At.sum(axis=0), Aj.sum(axis=0), D.sum(axis=0))
    from hpclinalg_torch.ops import reductions

    close(reductions.row_abs_sum(At), hl.ops.reductions.row_abs_sum(Aj),
          np.abs(D).sum(axis=1))
    close(reductions.col_abs_sum(At), hl.ops.reductions.col_abs_sum(Aj),
          np.abs(D).sum(axis=0))
