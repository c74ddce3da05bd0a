"""Sparse row repartitioning.

Port of the JAX package's ``hpclinalg/ops/sparse_repartition.py`` (ref:
SparseRepartitionPlan, sparse.jl:4098-4573): the structure is re-sliced on
the host and the values move by one static ExchangePlan: on a process
group one ``all_to_all_single`` of the stored values.
"""

from __future__ import annotations

import numpy as np

from ..cache import cached_plan
from ..hashing import partition_hash
from ..partition import nshards_of, validate_partition
from ..parallel.exchange import ExchangePlan


def _build(A, p2):
    from ..sparse import SparseStructure, compress_cols

    st = A.structure
    S = A.backend.nshards
    # global CSR row lengths and offsets
    rowlen = np.concatenate([np.diff(ip) for ip in st.indptr])
    g_indptr = np.concatenate([[0], np.cumsum(rowlen)]).astype(np.int64)
    gcols = [c for _r, c in st.global_coo]  # global cols in storage order

    indptr, col_indices, colval = [], [], []
    send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    p1 = st.row_partition
    for d in range(S):
        lo, hi = int(p2[d]), int(p2[d + 1])
        ip = np.zeros(hi - lo + 1, dtype=np.int64)
        ip[1:] = np.cumsum(rowlen[lo:hi])
        indptr.append(ip)
        # columns of the rows moving to d, in global row order (the source
        # shards are visited in row order)
        cols_d = []
        for s in range(S):
            a, b = max(lo, int(p1[s])), min(hi, int(p1[s + 1]))
            if a >= b:
                continue
            st_lo = g_indptr[a] - g_indptr[p1[s]]
            st_hi = g_indptr[b] - g_indptr[p1[s]]
            cols_d.append(gcols[s][st_lo:st_hi])
            send[s][d] = np.arange(st_lo, st_hi)
            recv[d][s] = np.arange(g_indptr[a] - g_indptr[lo],
                                   g_indptr[b] - g_indptr[lo])
        ci, cv = compress_cols(np.concatenate(cols_d) if cols_d
                               else np.zeros(0, np.int64))
        col_indices.append(ci)
        colval.append(cv)
    new_st = SparseStructure(p2, st.col_partition, indptr, col_indices, colval,
                             A.backend)
    return new_st, ExchangePlan(A.backend, send, recv, new_st.NNZpad)


def repartition_sparse(A, new_row_partition):
    """Ref: repartition (sparse.jl:4573)."""
    from ..sparse import DistSparseMatrix

    p2 = validate_partition(new_row_partition, A.m)
    if nshards_of(p2) != A.backend.nshards:
        raise ValueError("new partition must have the same shard count as the mesh")
    if partition_hash(p2) == partition_hash(A.row_partition):
        return A
    key = (A.hash, partition_hash(p2), A.backend.key)
    new_st, plan = cached_plan("sparse_repartition", key, lambda: _build(A, p2))
    return DistSparseMatrix(new_st, plan.apply(A.nzval), A.backend)
