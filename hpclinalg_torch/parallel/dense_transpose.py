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


def dense_transpose(A):
    """Aᵀ of a DistDenseMatrix, rows on A's ``col_partition``."""
    from ..dense import DistDenseMatrix

    be = A.backend
    cp = A.col_partition
    S, Lrow, ncols = A.data.shape
    if S * Lrow * ncols >= 2 ** 31:
        raise ValueError("dense transpose exceeds int32 indexing")
    key = (A.row_partition_hash, partition_hash(cp), ncols, Lrow, be.key)
    src = cached_plan(
        "dense_transpose", key,
        lambda: be.tensor(_transpose_table(A.row_partition, Lrow, ncols, cp)
                          .reshape(1, -1)))
    data = gather(A.data.reshape(1, -1), src).reshape(S, -1, A.m)
    return DistDenseMatrix(data, cp, A.m, be, col_partition=A.row_partition)
