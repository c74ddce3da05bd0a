"""Repartitioning: redistributing vector entries and dense rows onto a new
partition.

Port of the JAX package's ``hpclinalg/ops/repartition.py`` (ref:
VectorRepartitionPlan, vectors.jl:491-712; DenseRepartitionPlan,
dense.jl:1571-1761). Both partitions are host metadata, so the contiguous
overlaps are numpy; the value movement is one static ExchangePlan (a
gather plus a scatter on the stacked tensor).
"""

from __future__ import annotations

import numpy as np

from ..backend import Backend
from ..cache import cached_plan
from ..hashing import partition_hash
from ..partition import nshards_of, padded_size, validate_partition
from ..parallel.exchange import ExchangePlan


def overlap_exchange_plan(backend: Backend, p_src: np.ndarray,
                          p_dst: np.ndarray) -> ExchangePlan:
    """ExchangePlan moving contiguous global rows from partition p_src to
    p_dst (ref ctor logic: vectors.jl:519-619)."""
    S = backend.nshards
    send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    for s in range(S):
        a0, a1 = int(p_src[s]), int(p_src[s + 1])
        for d in range(S):
            b0, b1 = int(p_dst[d]), int(p_dst[d + 1])
            lo, hi = max(a0, b0), min(a1, b1)
            if lo < hi:
                send[s][d] = np.arange(lo - a0, hi - a0)
                recv[d][s] = np.arange(lo - b0, hi - b0)
    return ExchangePlan(backend, send, recv, padded_size(p_dst))


def get_repartition_plan(backend: Backend, p_src: np.ndarray,
                         p_dst: np.ndarray) -> ExchangePlan:
    key = (partition_hash(p_src), partition_hash(p_dst), backend.key)
    return cached_plan("repartition", key,
                       lambda: overlap_exchange_plan(backend, p_src, p_dst))


def repartition(x, new_partition: np.ndarray):
    """A DistVector's entries, or a DistSparseMatrix's or DistDenseMatrix's
    rows, on a new partition (ref: repartition, vectors.jl:712 and
    sparse.jl:4573)."""
    return x.repartition(new_partition)


def repartition_vector(v, new_partition: np.ndarray):
    """Ref: repartition(v, partition) (vectors.jl:712)."""
    from ..vector import DistVector

    p2 = validate_partition(new_partition, v.n)
    if nshards_of(p2) != v.backend.nshards:
        raise ValueError("new partition must have the same shard count as the mesh")
    if partition_hash(p2) == v.partition_hash:
        return v
    plan = get_repartition_plan(v.backend, v.partition, p2)
    return DistVector(plan.apply(v.data), p2, v.backend)


def repartition_dense(A, new_partition: np.ndarray):
    """Ref: DenseRepartitionPlan (dense.jl:1571-1761). Rows move with their
    whole (ncols,) payload through the same exchange as a vector's
    entries."""
    from ..dense import DistDenseMatrix

    p2 = validate_partition(new_partition, A.m)
    if nshards_of(p2) != A.backend.nshards:
        raise ValueError("new partition must have the same shard count as the mesh")
    if partition_hash(p2) == A.row_partition_hash:
        return A
    plan = get_repartition_plan(A.backend, A.row_partition, p2)
    return DistDenseMatrix(plan.apply(A.data), p2, A.ncols, A.backend)
