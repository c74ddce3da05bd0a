"""Range and fancy indexing of distributed dense matrices.

Port of the JAX package's ``hpclinalg/ops/dense_index.py`` (ref: the dense
paths of indexing.jl, A[rng, rng] :691, A[:, k] :872, fancy :1654). Rows
move through one cached ``ExchangePlan`` with whole-row payloads; columns
are replicated within a row block, so selecting them is a local
``index_select``.
"""

from __future__ import annotations

import numpy as np

from ..cache import cached_plan
from ..parallel import comm
from ..partition import padded_size, uniform_partition
from .gather import gather_exchange_plan
from .indexing import _split, check_ids_bounds, key_ids, subrange_partition


def _rows_plan(backend, partition, phash, rids, rtag, cache):
    """The plan gathering rows ``rids`` out of ``partition`` and the
    result's row partition: the subrange's for a slice, else uniform (a
    distributed id vector's partition is not kept, as in the JAX
    package)."""
    rp2 = (subrange_partition(partition, *rtag[1:]) if rtag[0] == "slice"
           else uniform_partition(len(rids), backend.nshards))
    plan = cached_plan(
        cache, (phash, rtag, backend.key),
        lambda: gather_exchange_plan(backend, partition, _split(rids, rp2),
                                     out_len=padded_size(rp2)))
    return plan, rp2


def dense_getindex(A, key):
    from ..dense import DistDenseMatrix
    from ..parallel.mesh import scatter_from_full
    from ..vector import DistVector

    if not isinstance(key, tuple) or len(key) != 2:
        raise TypeError("matrix indexing requires A[rows, cols]")
    rkey, ckey = key
    m, n = A.shape
    backend = A.backend

    # A[k, cols] -> the row as a DistVector (the transpose analogue of A[:, k])
    if isinstance(rkey, (int, np.integer)) and not isinstance(
            ckey, (int, np.integer)):
        check_ids_bounds(np.array([int(rkey)]), m, "row")
        R = dense_getindex(A, (slice(int(rkey), int(rkey) + 1), ckey))
        # (ncols,): the one valid row, which on a group lives in one rank
        full = comm.all_reduce(backend, R.data.sum(dim=(0, 1)))
        rp = uniform_partition(R.ncols, backend.nshards)
        return DistVector(scatter_from_full(full, rp, backend), rp, backend)

    rids, rtag = key_ids(rkey, m, "row")
    if isinstance(ckey, (int, np.integer)):
        # A[rows, k] -> the column as a DistVector (ref indexing.jl:872)
        check_ids_bounds(np.array([int(ckey)]), n, "column")
        v = DistVector(A.data[:, :, int(ckey)].contiguous(), A.row_partition,
                       backend)
        plan, rp2 = _rows_plan(backend, v.partition, v.partition_hash, rids,
                               rtag, "dense_column_getindex")
        return DistVector(plan.apply(v.data), rp2, backend)

    cids = key_ids(ckey, n, "column")[0]
    plan, rp2 = _rows_plan(backend, A.row_partition, A.row_partition_hash,
                           rids, rtag, "dense_getindex")
    rows = plan.apply(A.data)                       # (S, L2, ncols)
    out = rows.index_select(2, backend.tensor(cids))
    return DistDenseMatrix(out, rp2, len(cids), backend)
