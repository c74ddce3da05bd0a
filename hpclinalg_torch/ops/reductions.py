"""Row/column reductions over distributed sparse matrices.

Port of the JAX package's ``hpclinalg/ops/reductions.py``. Row sums are a
local segment sum over each stored value's row; column sums reduce into
each shard's compressed column space and then scatter-add to the column
owners through one cached ``ExchangePlan`` (``apply(..., add=True)``).

Both segment sums are one ``index_add_`` on this process's flattened
shards (all S stacked, or its own on a process group). The padding slots
of ``nzval`` (zero by the padding invariant) go to slots of their own past
the end of the output, one each, so no two of them collide on one address
and none lands on a real row.

The scalars (``norm`` and the sum behind ``mean``, ``maximum``,
``minimum``) reduce this process's values and, on a group, all-reduce the
partial result, as the JAX package's psum/pmax/pmin do: a 0-d tensor, the
same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cache import cached_plan
from ..parallel import comm


def _segment_index(st, ids: np.ndarray, width: int) -> torch.Tensor:
    """(nlocal*NNZpad,) int64 destinations in a flat (nlocal*width + npad)
    buffer: stored value k of this process's j-th shard s goes to
    j*width + ids[s, k], each padding slot to a slot of its own past
    nlocal*width."""
    sh = st.backend.shards
    ids = ids[sh.start: sh.stop]
    S, P = ids.shape
    valid = np.arange(P)[None, :] < st.nnz_local[sh.start: sh.stop, None]
    dst = np.arange(S, dtype=np.int64)[:, None] * width + ids.astype(np.int64)
    dst[~valid] = S * width + np.arange(int((~valid).sum()), dtype=np.int64)
    return st.backend.tensor(dst.reshape(-1))


def _segment_sum(st, vals: torch.Tensor, dst: torch.Tensor,
                 width: int) -> torch.Tensor:
    S = vals.shape[0]
    sh = st.backend.shards
    nnz = int(st.nnz_local[sh.start: sh.stop].sum())
    out = vals.new_zeros(S * width + dst.numel() - nnz)
    out.index_add_(0, dst, vals.reshape(-1))
    return out[: S * width].reshape(S, width)


def _row_index(A) -> torch.Tensor:
    st = A.structure
    return cached_plan("rowsum_index", (A.hash, A.backend.key),
                       lambda: _segment_index(st, st.row_ids, st.Lrow))


def _col_index(A) -> torch.Tensor:
    st = A.structure

    def build():
        ids = np.zeros((A.backend.nshards, st.NNZpad), dtype=np.int64)
        for s in range(A.backend.nshards):
            ids[s, : st.nnz_local[s]] = st.colval[s]
        return _segment_index(st, ids, st.Gpad)

    return cached_plan("colsum_index", (A.hash, A.backend.key), build)


def _row_reduce(A, vals):
    from ..vector import DistVector

    st = A.structure
    y = _segment_sum(st, vals, _row_index(A), st.Lrow)
    return DistVector(y, st.row_partition, A.backend)


def row_sum(A):
    return _row_reduce(A, A.nzval)


def row_abs_sum(A):
    return _row_reduce(A, torch.abs(A.nzval))


def _col_reduce(A, vals):
    from ..vector import DistVector
    from .gather import scatter_exchange_plan

    st = A.structure
    partial = _segment_sum(st, vals, _col_index(A), st.Gpad)
    # the source "partition" is positional: shard s holds len(col_indices[s])
    # partial sums at slots 0.., bound for the global columns col_indices[s]
    plan = cached_plan(
        "colsum_plan", (A.hash, A.backend.key),
        lambda: scatter_exchange_plan(A.backend, st.row_partition,
                                      st.col_indices, st.col_partition))
    y = plan.apply(partial, add=True)
    return DistVector(y, st.col_partition, A.backend)


def col_sum(A):
    return _col_reduce(A, A.nzval)


def col_abs_sum(A):
    return _col_reduce(A, torch.abs(A.nzval))


def trace(A):
    """tr(A), the sum of the main diagonal."""
    return A.diag(0).sum()


def _full(A) -> bool:
    return A.nnz() == A.m * A.ncols


def norm(A, p=2):
    """The elementwise p-norm of the stored values (Frobenius for p = 2):
    on a group the sum of |a|^p over the ranks, then the root (the max for
    p = inf)."""
    be = A.backend
    a = torch.abs(A.nzval)
    if p == np.inf:
        return comm.all_reduce(be, torch.max(a), "max")
    if p == 2:
        return torch.sqrt(comm.all_reduce(be, torch.sum(a ** 2)))
    if p == 1:
        return comm.all_reduce(be, torch.sum(a))
    return comm.all_reduce(be, torch.sum(a ** p)) ** (1.0 / p)


def total(A):
    """The sum of all stored values."""
    return comm.all_reduce(A.backend, torch.sum(A.nzval))


def maximum(A):
    """The largest entry, the implicit zeros counted when the matrix is not
    full (a full matrix of negative entries does not report 0)."""
    stored = comm.all_reduce(A.backend, torch.where(
        A.structure.nnz_mask_dev, A.nzval,
        torch.tensor(-np.inf, dtype=A.dtype, device=A.nzval.device)).max(),
        "max")
    return stored if _full(A) else torch.maximum(stored, stored.new_zeros(()))


def minimum(A):
    stored = comm.all_reduce(A.backend, torch.where(
        A.structure.nnz_mask_dev, A.nzval,
        torch.tensor(np.inf, dtype=A.dtype, device=A.nzval.device)).min(),
        "min")
    return stored if _full(A) else torch.minimum(stored, stored.new_zeros(()))


def mean(A):
    """The mean over all m*n entries, the implicit zeros counted."""
    return total(A) / (A.m * A.ncols)
