"""Sparse transpose materialization.

Port of the JAX package's ``hpclinalg/ops/transpose.py`` (ref:
TransposePlan, sparse.jl:1519-1829). The symbolic construction of Aᵀ's CSR
structure runs on host metadata and gives the JAX package's arrays and
hash; the value movement is one static ExchangePlan permutation from A's
storage order into Aᵀ's (K2's gather mode plus ``index_copy_``; on a
process group one ``all_to_all_single`` of the stored values).
"""

from __future__ import annotations

import weakref

import numpy as np

from ..cache import cached_plan
from ..partition import owner_of
from ..parallel.exchange import ExchangePlan


def _build_transpose_plan(A):
    from ..sparse import SparseStructure, compress_cols, csr_from_rows

    st = A.structure
    S = A.backend.nshards
    rp, cp = st.row_partition, st.col_partition

    # every stored entry: (gcol, grow, source shard, source storage position)
    coo = st.global_coo
    grow = np.concatenate([r for r, _c in coo])
    gcol = np.concatenate([c for _r, c in coo])
    src = np.repeat(np.arange(S, dtype=np.int64), st.nnz_local)
    pos = np.arange(st.nnz, dtype=np.int64) - np.repeat(
        np.cumsum(st.nnz_local) - st.nnz_local, st.nnz_local)

    # Aᵀ storage order: sort by (owner(gcol), gcol, grow)
    order = np.lexsort((grow, gcol))
    gcol, grow, src, pos = gcol[order], grow[order], src[order], pos[order]
    dst = owner_of(cp, gcol)
    bounds = np.searchsorted(dst, np.arange(S + 1))

    indptr, col_indices, colval = [], [], []
    send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    for d in range(S):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        indptr.append(csr_from_rows(gcol[lo:hi] - cp[d], int(cp[d + 1] - cp[d])))
        ci, cv = compress_cols(grow[lo:hi])
        col_indices.append(ci)
        colval.append(cv)
        at_pos = np.arange(hi - lo, dtype=np.int64)
        for s in range(S):
            ms = src[lo:hi] == s
            if ms.any():
                send[s][d] = pos[lo:hi][ms]
                recv[d][s] = at_pos[ms]

    at_st = SparseStructure(cp, rp, indptr, col_indices, colval, A.backend)
    plan = ExchangePlan(A.backend, send, recv, at_st.NNZpad)
    return at_st, plan


def get_transpose_plan(A):
    return cached_plan("transpose_plan", (A.hash, A.backend.key),
                       lambda: _build_transpose_plan(A))


def materialize_transpose(A):
    """Ref: HPCSparseMatrix{T}(transpose(A)) (sparse.jl:1846-1865), with the
    same bidirectional result caching (``DistSparseMatrix.cached_transpose``:
    the back reference is weak)."""
    from ..sparse import DistSparseMatrix

    At = A.cached_transpose
    if At is not None:
        return At
    at_st, plan = get_transpose_plan(A)
    At = DistSparseMatrix(at_st, plan.apply(A.nzval), A.backend)
    A._transpose = At
    At._transpose = weakref.ref(A)
    return At
