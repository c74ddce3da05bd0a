"""Dense transpose materialisation.

Port of the JAX package's ``hpclinalg/parallel/dense_transpose.py`` (ref:
DenseTransposePlan, dense.jl:690-978). There each shard slices its column
window per destination, one all_to_all moves the blocks and a static take
reassembles the transposed rows. All S shards of the port live stacked in
one tensor, so the whole plan is one gather of the flattened stack (K2's
gather mode, ``ops/cuda_ell.py``) from a table built on the host: slot
(d, r, j) of Aᵀ's (S, Lout, m) stack reads A[j, cp[d] + r], and the
padding rows of Aᵀ read nothing (a dead slot gives 0).
"""

from __future__ import annotations

import numpy as np

from ..cache import cached_plan
from ..hashing import partition_hash
from ..ops.cuda_ell import check_index, gather
from ..partition import padded_size, partition_sizes
from .exchange import ExchangePlan
from .mesh import _unpad_index


def _transpose_table(row_partition, Lrow: int, ncols: int,
                     col_partition) -> np.ndarray:
    """(S, Lout, m) flat source slots of Aᵀ's stack in A's flattened
    (S·Lrow·ncols) stack; -1 marks a padding row."""
    rows = _unpad_index(row_partition, Lrow)            # (m,) stack rows
    csz = partition_sizes(col_partition)
    Lout = padded_size(col_partition)
    r = np.arange(Lout, dtype=np.int64)
    c = col_partition[:-1, None] + r[None, :]           # (S, Lout) columns
    live = r[None, :] < csz[:, None]
    src = rows[None, None, :] * ncols + c[:, :, None]
    src = np.where(live[:, :, None], src, -1)
    check_index("dense_transpose", src, len(row_partition[:-1]) * Lrow * ncols,
                dead_below_zero=True)
    return src.astype(np.int32)


def _transpose_exchange(backend, row_partition, Lrow: int, ncols: int,
                        col_partition) -> ExchangePlan:
    """The group's plan: source shard s sends A[j, c] (flat slot
    (j - rp[s])·ncols + c of its rows) for its rows j and destination d's
    columns c to Aᵀ's flat slot (c - cp[d])·m + j on d."""
    S = backend.nshards
    m = int(row_partition[-1])
    send = [[None] * S for _ in range(S)]
    recv = [[None] * S for _ in range(S)]
    for s in range(S):
        j = np.arange(row_partition[s], row_partition[s + 1], dtype=np.int64)
        for d in range(S):
            r = np.arange(col_partition[d + 1] - col_partition[d],
                          dtype=np.int64)
            c = col_partition[d] + r
            send[s][d] = ((j - row_partition[s])[:, None] * ncols
                          + c[None, :]).reshape(-1)
            recv[d][s] = (r[None, :] * m + j[:, None]).reshape(-1)
    return ExchangePlan(backend, send, recv,
                        padded_size(col_partition) * m,
                        src_sizes=[Lrow * ncols] * S)


def dense_transpose(A):
    """Aᵀ of a DistDenseMatrix, rows on A's ``col_partition``."""
    from ..dense import DistDenseMatrix

    be = A.backend
    cp = A.col_partition
    S, Lrow, ncols = A.data.shape
    if S * Lrow * ncols >= 2 ** 31:
        raise ValueError("dense transpose exceeds int32 indexing")
    key = (A.row_partition_hash, partition_hash(cp), ncols, Lrow, be.key)
    if be.is_dist:
        plan = cached_plan(
            "dense_transpose", key,
            lambda: _transpose_exchange(be, A.row_partition, Lrow, ncols, cp))
        Lout = padded_size(cp)
        data = plan.apply(A.data.reshape(S, -1))[:, : Lout * A.m]
        return DistDenseMatrix(data.reshape(S, Lout, A.m), cp, A.m, be,
                               col_partition=A.row_partition)
    src = cached_plan(
        "dense_transpose", key,
        lambda: be.tensor(_transpose_table(A.row_partition, Lrow, ncols, cp)
                          .reshape(1, -1)))
    data = gather(A.data.reshape(1, -1), src).reshape(S, -1, A.m)
    return DistDenseMatrix(data, cp, A.m, be, col_partition=A.row_partition)
