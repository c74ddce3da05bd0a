"""diag / triu / tril / dropzeros for distributed sparse matrices.

Port of the JAX package's ``hpclinalg/ops/diagonal.py`` (ref: diag(A, k)
sparse.jl:2801, triu/tril sparse.jl:2874/2971, dropzeros sparse.jl:2755).
Structure filtering is host-side; value movement is a cached ExchangePlan
(on a process group, ``diag``'s crosses ranks in one ``all_to_all_single``;
``triu`` and ``tril`` stay on each rank).
"""

from __future__ import annotations

import numpy as np

from ..cache import cached_plan
from ..partition import global_to_local, padded_size, uniform_partition
from ..parallel.exchange import ExchangePlan


def diag(A, k: int = 0):
    """k-th diagonal as a DistVector of length min(m, n-k) (k>=0) or
    min(m+k, n) (k<0), matching Julia's diag (ref sparse.jl:2801)."""
    from ..vector import DistVector

    m, n = A.shape
    dlen = max(0, min(m, n - k) if k >= 0 else min(m + k, n))
    st = A.structure
    S = A.backend.nshards

    def build():
        # per shard: storage positions of the entries on the k-diagonal, and
        # the diagonal index each lands on
        pos, didx = [], []
        for r, c in st.global_coo:
            msk = c == r + k
            pos.append(np.flatnonzero(msk))
            didx.append(r[msk] if k >= 0 else c[msk])
        dpart = uniform_partition(dlen, S)
        return build_position_scatter(A.backend, pos, didx, dpart), dpart

    plan, dpart = cached_plan("diag_plan", (A.hash, k, A.backend.key), build)
    return DistVector(plan.apply(A.nzval), dpart, A.backend)


def build_position_scatter(backend, src_positions, dst_global, dst_partition):
    """ExchangePlan sending source storage slots ``src_positions[s]`` to the
    global rows ``dst_global[s]`` of a vector over ``dst_partition``."""
    S = backend.nshards
    send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    for s in range(S):
        owners, loc = global_to_local(dst_partition, dst_global[s])
        for d in range(S):
            msk = owners == d
            if msk.any():
                send[s][d] = src_positions[s][msk]
                recv[d][s] = loc[msk]
    return ExchangePlan(backend, send, recv, padded_size(dst_partition))


def _filter_structure(A, keep_fn):
    """Plan builder keeping the entries where keep_fn(grow, gcol): a local
    value permutation, no shard reads another's values."""
    from ..sparse import SparseStructure, compress_cols, csr_from_rows

    st = A.structure
    S = A.backend.nshards

    def build():
        indptr, col_indices, colval, send = [], [], [], []
        for s, (r, c) in enumerate(st.global_coo):
            msk = keep_fn(r, c)
            send.append(np.flatnonzero(msk))
            indptr.append(csr_from_rows(r[msk] - st.row_partition[s],
                                        len(st.indptr[s]) - 1))
            ci, cv = compress_cols(c[msk])
            col_indices.append(ci)
            colval.append(cv)
        new_st = SparseStructure(st.row_partition, st.col_partition, indptr,
                                 col_indices, colval, A.backend)
        sends = [[send[s] if d == s else np.zeros(0, np.int64)
                  for d in range(S)] for s in range(S)]
        recvs = [[np.arange(len(send[s])) if d == s else np.zeros(0, np.int64)
                  for d in range(S)] for s in range(S)]
        return new_st, ExchangePlan(A.backend, sends, recvs, new_st.NNZpad)

    return build


def triu(A, k: int = 0):
    from ..sparse import DistSparseMatrix

    st, plan = cached_plan("triu_plan", (A.hash, k, A.backend.key),
                           _filter_structure(A, lambda r, c: c >= r + k))
    return DistSparseMatrix(st, plan.apply(A.nzval), A.backend)


def tril(A, k: int = 0):
    from ..sparse import DistSparseMatrix

    st, plan = cached_plan("tril_plan", (A.hash, k, A.backend.key),
                           _filter_structure(A, lambda r, c: c <= r + k))
    return DistSparseMatrix(st, plan.apply(A.nzval), A.backend)


def dropzeros(A, tol: float = 0.0):
    """Drop stored values with |v| <= tol (ref sparse.jl:2755). The result's
    structure depends on the values, so it reads them back to the host and
    is not cached. It is the one plan of the sparse algebra whose build
    communicates: on a process group every rank needs the same global
    structure but holds only its own values, so the (NNZpad-wide) shards
    are all-gathered first, in one collective, and every rank runs the same
    host code on all of them."""
    from ..parallel import comm
    from ..sparse import DistSparseMatrix, csr_from_rows

    nz = comm.all_gather_rows(A.backend, A.nzval).detach().cpu().numpy()
    st = A.structure
    parts = []
    for s, (r, c) in enumerate(st.global_coo):
        v = nz[s, : st.nnz_local[s]]
        keep = np.abs(v) > tol
        parts.append((csr_from_rows(r[keep] - st.row_partition[s],
                                    len(st.indptr[s]) - 1), c[keep], v[keep]))
    return DistSparseMatrix.from_local_csr(
        parts, A.ncols, A.backend, col_partition=st.col_partition, dtype=A.dtype)
