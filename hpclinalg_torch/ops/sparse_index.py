"""Range and fancy indexing of distributed sparse matrices.

Port of the JAX package's ``hpclinalg/ops/sparse_index.py``: A[rows, cols]
for slices, host id arrays and distributed id vectors, and the vector
forms A[rows, k] and A[k, cols]. The result's structure is built on the
host from the replicated structure, and its values move through one cached
``ExchangePlan`` (K2's gather mode on the card).

``assemble`` is the host assembly shared with ``ops/blocks.py``: it takes
every output entry at once (the JAX package loops over source and
destination shards) and yields the same structure, hash and moves.
"""

from __future__ import annotations

import numpy as np

from ..cache import cached_plan
from ..parallel.exchange import ExchangePlan
from ..partition import uniform_partition
from .indexing import check_ids_bounds, key_ids, subrange_partition


def assemble(backend, rp2, cp2, rows, cols, group, src, pos, ngroups):
    """The distributed CSR structure holding entries at global (rows, cols)
    (unique pairs) under row partition ``rp2`` and column partition
    ``cp2``, and one ExchangePlan per group g in range(ngroups) moving the
    values of the entries with ``group == g``: source slot ``pos`` of shard
    ``src`` to the entry's slot in the new shard. Returns
    (structure, [plans])."""
    from ..sparse import SparseStructure, compress_cols

    S = backend.nshards
    # one int64 key per entry, row-major; a slice of a matrix arrives sorted
    # already, and then the sort is skipped
    key = rows * max(int(cp2[-1]), 1) + cols
    if len(key) > 1 and not bool(np.all(key[1:] > key[:-1])):
        order = np.argsort(key, kind="stable")
        rows, cols = rows[order], cols[order]
        group, src, pos = group[order], src[order], pos[order]
    # rows are sorted, so each destination shard's entries are one run
    bounds = np.searchsorted(rows, rp2)
    dst = np.repeat(np.arange(S, dtype=np.int64), np.diff(bounds))
    newpos = np.arange(len(rows), dtype=np.int64) - bounds[dst]
    indptr, col_indices, colval = [], [], []
    for d in range(S):
        lo, hi = bounds[d], bounds[d + 1]
        nl = int(rp2[d + 1] - rp2[d])
        indptr.append(np.concatenate([[0], np.cumsum(np.bincount(
            rows[lo:hi] - rp2[d], minlength=nl))]).astype(np.int64))
        ci, cv = compress_cols(cols[lo:hi])
        col_indices.append(ci)
        colval.append(cv)
    st = SparseStructure(rp2, cp2, indptr, col_indices, colval, backend)

    # the moves of each (group, source shard, destination shard), each in
    # the order of the new slots
    key = (group * S + src) * S + dst
    by = np.argsort(key, kind="stable")
    cuts = np.searchsorted(key[by], np.arange(ngroups * S * S + 1))
    plans = []
    for g in range(ngroups):
        send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
        recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
        for s in range(S):
            for d in range(S):
                k = (g * S + s) * S + d
                sel = by[cuts[k]: cuts[k + 1]]
                if len(sel):
                    send[s][d] = pos[sel]
                    recv[d][s] = newpos[sel]
        plans.append(ExchangePlan(backend, send, recv, st.NNZpad))
    return st, plans


def _expand(ids, tag, values):
    """For each of ``values``, every position of the id list ``ids`` that
    selects it: (index into values, output position), so one source entry
    fans out to every output that asks for it. A slice selects each value
    at most once, at an output position it computes."""
    if tag[0] == "slice":
        start, stop, step = tag[1:]
        hit = (values >= start) & (values < stop) & ((values - start)
                                                     % step == 0)
        which = np.flatnonzero(hit)
        return which, (values[which] - start) // step
    order = np.argsort(ids, kind="stable")
    ids_sorted = ids[order]
    lo = np.searchsorted(ids_sorted, values, side="left")
    hi = np.searchsorted(ids_sorted, values, side="right")
    cnt = hi - lo
    which = np.repeat(np.arange(len(values)), cnt)
    within = np.arange(len(which)) - np.repeat(
        np.concatenate([[0], np.cumsum(cnt)])[:-1], cnt)
    return which, order[np.repeat(lo, cnt) + within]


def _build(A, rids, rtag, cids, ctag):
    st = A.structure
    S = A.backend.nshards
    # result rows: locality-preserving for a slice, uniform otherwise
    if rtag[0] == "slice":
        rp2 = subrange_partition(st.row_partition, *rtag[1:])
    else:
        rp2 = uniform_partition(len(rids), S)
    nr, nc, srcs, poss = [], [], [], []
    for s in range(S):
        r, c = st.global_coo[s]
        e_r, out_r = _expand(rids, rtag, r)
        if not len(e_r):
            continue
        e_rc, out_c = _expand(cids, ctag, c[e_r])
        nr.append(out_r[e_rc])
        nc.append(out_c)
        poss.append(e_r[e_rc])   # source slot, may repeat
        srcs.append(np.full(len(out_c), s, np.int64))
    cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int64))
    nr, nc, srcs, poss = cat(nr), cat(nc), cat(srcs), cat(poss)
    new_st, (plan,) = assemble(A.backend, rp2, uniform_partition(len(cids), S),
                               nr, nc, np.zeros(len(nr), np.int64), srcs,
                               poss, 1)
    return new_st, plan


def sparse_getindex(A, key):
    from ..sparse import DistSparseMatrix
    from .reductions import col_sum, row_sum

    if not isinstance(key, tuple) or len(key) != 2:
        raise TypeError("matrix indexing requires A[rows, cols]")
    rkey, ckey = key
    m, n = A.shape
    r_int = isinstance(rkey, (int, np.integer))
    c_int = isinstance(ckey, (int, np.integer))
    # A[rows, k] -> DistVector (ref: A[:, k], indexing.jl:385), and its
    # transpose analogue A[k, cols]
    if c_int and not r_int:
        check_ids_bounds(np.array([int(ckey)]), n, "column")
        return row_sum(sparse_getindex(A, (rkey, slice(int(ckey),
                                                       int(ckey) + 1))))
    if r_int and not c_int:
        check_ids_bounds(np.array([int(rkey)]), m, "row")
        return col_sum(sparse_getindex(A, (slice(int(rkey), int(rkey) + 1),
                                           ckey)))
    rids, rtag = key_ids(rkey, m, "row")
    cids, ctag = key_ids(ckey, n, "column")
    new_st, plan = cached_plan("sparse_getindex",
                               (A.hash, rtag, ctag, A.backend.key),
                               lambda: _build(A, rids, rtag, cids, ctag))
    return DistSparseMatrix(new_st, plan.apply(A.nzval), A.backend)
